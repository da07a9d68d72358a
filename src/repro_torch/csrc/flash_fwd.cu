// Causal GQA flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_fwd.py
// (_flash_fwd_kernel / flash_fwd_pallas) and follows the function the
// reference's serve path runs (models/flash_attention.py::_flash_fwd_impl):
//   * q is scaled in its own dtype: round(q * round(D^-0.5));
//   * scores are f32 sums of q.k, optional tanh softcap, -1e30 mask for
//     kv_pos >= Tk and (causal) kv_pos > q_pos;
//   * online softmax in f32 (running max m, denominator l of the unrounded
//     p), while p is rounded to v's dtype before the p.v product, which
//     accumulates in f32;
//   * o = acc / max(l, 1e-30), stored in v's dtype.
// (The Pallas kernel keeps p in f32 for p.v; at f32 the two agree.)
//
// One CTA of 256 threads per (b*Hq + h, 64-row q block); GQA head h reads
// kv head h / (Hq/Hkv).  The CTA loops over 64-key K/V tiles staged in
// shared memory (f32, zero-filled past Tk), and under causality stops at
// the last key its rows can see, so the ragged edges of any Tq/Tk are
// masked here and need no padding by the caller.  Bound on the H100:
// operations (4*D flops per visible (q, k) pair); this first version does
// them as scalar f32 FMAs from shared memory (no mma/wgmma yet).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG = -1e30f;

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static __device__ float load(float x) { return x; }
  static __device__ float round(float x) { return x; }
  static __device__ float store(float x) { return x; }
};
template <>
struct Elem<__nv_bfloat16> {
  static __device__ float load(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <>
struct Elem<__half> {
  static __device__ float load(__half x) { return __half2float(x); }
  static __device__ float round(float x) {
    return __half2float(__float2half_rn(x));
  }
  static __device__ __half store(float x) { return __float2half_rn(x); }
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t(BQ) * (D + 1) + size_t(BK) * (D + 1) + size_t(BK) * D +
          size_t(BQ) * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
                 int Tq, int Tk, float scale, float softcap, int causal) {
  constexpr int LD = D + 1;   // padded row stride of the Q and K tiles
  constexpr int LP = BK + 1;  // padded row stride of the score tile
  constexpr int CPT = D / 32; // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // BQ x LD, scaled q
  float* sK = sQ + BQ * LD;    // BK x LD
  float* sV = sK + BK * LD;    // BK x D
  float* sP = sV + BK * D;     // BQ x LP, scores then rounded p
  float* sM = sP + BQ * LP;    // running max per row
  float* sL = sM + BQ;         // running denominator per row
  float* sC = sL + BQ;         // this tile's correction per row

  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;
  const T* qb = q + (size_t(b) * Hq + h) * Tq * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * Tk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Tk * D;
  T* ob = o + (size_t(b) * Hq + h) * Tq * D;

  const float scale_t = Elem<T>::round(scale);
  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < Tq) {
      x = Elem<T>::round(Elem<T>::load(qb[size_t(q0 + r) * D + c]) * scale_t);
    }
    sQ[r * LD + c] = x;
  }
  if (tid < BQ) {
    sM[tid] = NEG;
    sL[tid] = 0.f;
  }

  // output ownership: warp w holds rows 8w..8w+7, lane holds columns
  // lane + 32j (consecutive lanes read consecutive V words)
  const int warp = tid / 32, lane = tid % 32;
  float acc[8][CPT];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  // score ownership: rows sr + 16i, columns sc + 16j
  const int sr = tid / 16, sc = tid % 16;
  // softmax ownership: 4 neighbouring threads per row
  const int pr = tid / 4, pp = tid % 4;

  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < Tk;
      sK[r * LD + c] = in ? Elem<T>::load(kb[size_t(k0 + r) * D + c]) : 0.f;
      sV[r * D + c] = in ? Elem<T>::load(vb[size_t(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(sr + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(sc + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr + 16 * i, c = sc + 16 * j;
        const int kv_pos = k0 + c, q_pos = q0 + r;
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        const bool keep = kv_pos < Tk && (!causal || kv_pos <= q_pos);
        sP[r * LP + c] = keep ? x : NEG;
      }
    }
    __syncthreads();

    {
      const float m_old = sM[pr];
      float mx = NEG;
      for (int jj = 0; jj < BK / 4; ++jj)
        mx = fmaxf(mx, sP[pr * LP + pp + 4 * jj]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int jj = 0; jj < BK / 4; ++jj) {
        const int idx = pr * LP + pp + 4 * jj;
        const float p = expf(sP[idx] - m_new);
        sum += p;
        sP[idx] = Elem<T>::round(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (pp == 0) {
        const float corr = expf(m_old - m_new);
        sL[pr] = sL[pr] * corr + sum;
        sM[pr] = m_new;
        sC[pr] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = warp * 8 + i;
      float t[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) t[j] = 0.f;
      for (int kk = 0; kk < BK; ++kk) {
        const float p = sP[row * LP + kk];
#pragma unroll
        for (int j = 0; j < CPT; ++j)
          t[j] = fmaf(p, sV[kk * D + lane + 32 * j], t[j]);
      }
      const float corr = sC[row];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = acc[i][j] * corr + t[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp * 8 + i;
    if (q0 + row < Tq) {
      const float l = fmaxf(sL[row], 1e-30f);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        ob[size_t(q0 + row) * D + lane + 32 * j] = Elem<T>::store(acc[i][j] / l);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Tq, int Tk, float scale, float softcap,
           int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(B * Hq, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Tq, Tk, scale,
      softcap, causal);
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Tq, int Tk, int D, float scale,
             float softcap, int causal, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, softcap,
                           causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Tq, Tk, scale, softcap,
                            causal, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         int B, int Hq, int Hkv, int Tq, int Tk, int D,
                         int dtype, int causal, float softcap, float scale,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale,
                             softcap, causal, s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D,
                                     scale, softcap, causal, s);
    case 2:
      return launch_d<__half>(q, k, v, o, B, Hq, Hkv, Tq, Tk, D, scale,
                              softcap, causal, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
