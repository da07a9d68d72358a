// Flash-attention backward for Hopper (sm_90a): the gradients dq, dk, dv of
// the causal / non-causal GQA attention of csrc/flash_fwd.cu.
//
// Replaces no TPU kernel: the reference's backward is the jnp function
// src/repro/models/flash_attention.py::_flash_bwd (l.142), which XLA
// compiles; on the card a loop of library calls over blocks would write
// every block's probabilities to device memory, so it is a kernel here.
// Its plain PyTorch version is models/flash_attention.py::flash_attention_bwd,
// and it follows that function's arithmetic:
//   * q is scaled in its own dtype, round(q * round(D^-0.5)), as in the
//     forward; scores are f32 sums of q.k, the optional tanh softcap, and
//     the mask kv_pos < Tk, q_pos < Tq and (causal) kv_pos <= q_pos;
//   * p = exp(s - m) / max(l, 1e-30) from the forward's row statistics
//     (m, l), recomputed per tile and never stored;
//   * delta = rowsum(dO * O) in f32;
//   * ds = p * (dp - delta) * (1 - tanh^2(s_raw / cap)), 0 where masked;
//   * p and ds rounded to the input dtype before the products dv += p^T dO,
//     dk += ds^T q_scaled, dq += ds k, which accumulate in f32;
//   * dq * D^-0.5 at the end; the GQA group's heads summed into dk, dv.
// Only the order of the f32 sums, and p * (1 - tanh^2) taken before the
// multiplication by (dp - delta), differ from the plain version.
//
// Two launches on the caller's stream, deterministic, no atomics:
//   (a) dq: one CTA per (b * Hq + h, 64 query rows).  It computes delta for
//       its rows from dO and O (and writes it out for (b)), then loops over
//       the K/V tiles its rows can see;
//   (b) dk / dv: one CTA per (b * Hkv + hk, 64 keys).  It loops over every
//       head of the GQA group and over the query tiles that can see its
//       keys, reading delta.
// Each warp owns 16 rows of its CTA's 64.  S (S^T in (b)) and dP are
// products over the head dim; P and dS are staged through the warp's own
// rows of shared memory, in the input dtype, as the A operand of the
// products over the tile.  At D = 256 a thread's two f32 accumulators of
// 256 columns would not fit its registers, so two groups of four warps
// split the output columns (128 each), both computing S and dP, as the
// forward kernel's D = 256 instance does.
//
// Bound on the H100: operations (five products of 2 * D flops per visible
// (q, k) pair, 2.5x the forward's).  bf16 and fp16 multiply on the tensor
// cores with warp-level mma.sync (m16n8k16, f32 accumulators), operands
// read from padded shared-memory rows (conflict-free 32-bit loads; the
// operands read along the tile's other axis are packed from two 16-bit
// loads).  f32 computes the same fragments with scalar FMAs: TF32 tensor
// cores would not give f32 results.  Later work: wgmma, TMA, warp
// specialisation.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // rows a CTA owns: queries in (a), keys in (b)

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

// output-column groups of four warps: D = 256 splits its columns in two
template <int D>
__host__ __device__ constexpr int groups() {
  return D > 128 ? 2 : 1;
}
// row padding: 16 bytes, so that 8 rows of 32-bit loads hit 32 banks
template <typename T>
__host__ __device__ constexpr int pad() {
  return 16 / int(sizeof(T));
}
// the tile each CTA loops over: keys in (a), queries in (b); f32 and the
// dk / dv accumulators of D >= 128 keep it at 32 rows for shared memory
// and registers
template <typename T, int D>
__host__ __device__ constexpr int bn_dq() {
  return sizeof(T) == 4 ? 32 : 64;
}
template <typename T, int D>
__host__ __device__ constexpr int bn_dkv() {
  return (sizeof(T) == 4 || D > 64) ? 32 : 64;
}

// shared memory of a CTA: its own 64 rows of two operands, the loop's tile
// of two, each warp's 16 staging rows, three f32 statistics a row
template <typename T, int D, int BN, int OWN_STATS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t(2 * BM + 2 * BN) * (D + pad<T>()) +
                      size_t(4 * groups<D>()) * 16 * (BN + pad<T>())) +
         sizeof(float) * 3 * (OWN_STATS ? BM : BN);
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// c (16 x 8 * NT8, f32, the mma C fragments: element e of n-tile j at
// c[4j + e] is row g + 8 * (e >> 1), column 8j + 2t + (e & 1), g = lane / 4,
// t = lane % 4) += A . B over KD, A row-major (16 rows of stride lda, k
// contiguous); B's (k, n) at B[n * ldb + k] when KMAJOR, else B[k * ldb + n]
template <typename T, int NT8, int KD, bool KMAJOR>
struct WarpMma {
  static __device__ __forceinline__ void run(float* c, const T* A, int lda,
                                             const T* B, int ldb, int lane) {
    static_assert(KD % 16 == 0, "k depth");
    const int g = lane >> 2, t = lane & 3;
    const uint16_t* a = reinterpret_cast<const uint16_t*>(A);
    const uint16_t* b = reinterpret_cast<const uint16_t*>(B);
#pragma unroll
    for (int k0 = 0; k0 < KD; k0 += 16) {
      uint32_t af[4];
      af[0] = ld32(a + g * lda + k0 + 2 * t);
      af[1] = ld32(a + (g + 8) * lda + k0 + 2 * t);
      af[2] = ld32(a + g * lda + k0 + 2 * t + 8);
      af[3] = ld32(a + (g + 8) * lda + k0 + 2 * t + 8);
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = 8 * j + g;
        uint32_t b0, b1;
        if constexpr (KMAJOR) {
          b0 = ld32(b + n * ldb + k0 + 2 * t);
          b1 = ld32(b + n * ldb + k0 + 2 * t + 8);
        } else {
          const uint16_t* col = b + (k0 + 2 * t) * ldb + n;
          b0 = uint32_t(col[0]) | (uint32_t(col[ldb]) << 16);
          b1 = uint32_t(col[8 * ldb]) | (uint32_t(col[9 * ldb]) << 16);
        }
        Mma<T>::run(c + 4 * j, af, b0, b1);
      }
    }
  }
};
// f32: the same fragments from scalar FMAs
template <int NT8, int KD, bool KMAJOR>
struct WarpMma<float, NT8, KD, KMAJOR> {
  static __device__ __forceinline__ void run(float* c, const float* A,
                                             int lda, const float* B, int ldb,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* a0p = A + g * lda;
    const float* a1p = A + (g + 8) * lda;
#pragma unroll 2
    for (int k = 0; k < KD; ++k) {
      const float a0 = a0p[k], a1 = a1p[k];
#pragma unroll
      for (int j = 0; j < NT8; ++j) {
        const int n = 8 * j + 2 * t;
        float b0, b1;
        if constexpr (KMAJOR) {
          b0 = B[n * ldb + k];
          b1 = B[(n + 1) * ldb + k];
        } else {
          b0 = B[k * ldb + n];
          b1 = B[k * ldb + n + 1];
        }
        c[4 * j + 0] = fmaf(a0, b0, c[4 * j + 0]);
        c[4 * j + 1] = fmaf(a0, b1, c[4 * j + 1]);
        c[4 * j + 2] = fmaf(a1, b0, c[4 * j + 2]);
        c[4 * j + 3] = fmaf(a1, b1, c[4 * j + 3]);
      }
    }
  }
};

// rows [r0, r0 + n) of a (T_rows, D) matrix into a padded tile (stride
// D + pad), 16 bytes a thread, rows past n_valid zero; ``scale_t`` (when
// not 1) multiplies in T, as the forward scales q
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rows,
                                          int n_valid, float scale_t,
                                          bool scaled, int tid, int nth) {
  constexpr int VEC = 16 / int(sizeof(T));
  constexpr int LD = D + pad<T>();
  for (int i = tid; i < rows * (D / VEC); i += nth) {
    const int r = i / (D / VEC), c = (i % (D / VEC)) * VEC;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < n_valid)
      raw = *reinterpret_cast<const uint4*>(src + size_t(r) * D + c);
    if (scaled) {
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = Elem<T>::store(Elem<T>::load(e[j]) * scale_t);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

// a warp's C fragments (16 x 8 * NT8) rounded to T into its staging rows
template <typename T, int NT8>
__device__ __forceinline__ void stage(T* stg, int ls, const float* x,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stg[(g + 8 * (e >> 1)) * ls + 8 * j + 2 * t + (e & 1)] =
          Elem<T>::store(x[4 * j + e]);
  }
}

// a warp's accumulator fragments (16 rows from ``row0`` of a (n_rows, D)
// output, columns c0 + 8j + 2t + {0, 1}) times ``mul``, rounded to T
template <typename T, int NT8, int D>
__device__ __forceinline__ void store_rows(T* out, const float* acc, int row0,
                                           int n_rows, int c0, float mul,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + g + 8 * hf;
      if (row < n_rows) {
        T* p = out + size_t(row) * D + c0 + 8 * j + 2 * t;
        p[0] = Elem<T>::store(acc[4 * j + 2 * hf] * mul);
        p[1] = Elem<T>::store(acc[4 * j + 2 * hf + 1] * mul);
      }
    }
  }
}

// (a) dq and delta
template <typename T, int D>
__global__ void __launch_bounds__(128 * groups<D>())
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ delta, int Hq, int Hkv, int Tq,
                    int Tk, float scale, float softcap, int causal,
                    int q_base) {
  constexpr int NW = 4 * groups<D>(), NTH = 32 * NW;
  constexpr int DV = D / groups<D>(), BN = bn_dq<T, D>();
  constexpr int LD = D + pad<T>(), LS = BN + pad<T>();
  constexpr int NS = BN / 8, NO = DV / 8;
  static_assert(smem_bytes<T, D, BN, 1>() <= 232448, "shared memory");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // BM x LD, scaled q
  T* sdO = sQ + BM * LD;                    // BM x LD
  T* sK = sdO + BM * LD;                    // BN x LD
  T* sV = sK + BN * LD;                     // BN x LD
  T* sS = sV + BN * LD;                     // NW x 16 x LS, ds staged
  float* sM = reinterpret_cast<float*>(sS + NW * 16 * LS);
  float* sL = sM + BM;
  float* sD = sL + BM;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * DV;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the longest causal rows first: block y runs q block gridDim.y - 1 - y
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t qrow = size_t(bh) * Tq;
  const T* kb = k + (size_t(b) * Hkv + hk) * Tk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Tk * D;
  const int n_q = min(BM, Tq - q0);

  load_tile<T, D>(sQ, q + (qrow + q0) * D, BM, n_q, Elem<T>::round(scale),
                  true, tid, NTH);
  load_tile<T, D>(sdO, dout + (qrow + q0) * D, BM, n_q, 1.f, false, tid,
                  NTH);
  // delta = rowsum(dO * O) in f32, one warp a row; the statistics beside it
  for (int r = warp; r < BM; r += NW) {
    float acc = 0.f;
    if (r < n_q) {
      const T* dr = dout + (qrow + q0 + r) * D;
      const T* orow = o + (qrow + q0 + r) * D;
      for (int c = lane; c < D; c += 32)
        acc = fmaf(Elem<T>::load(dr[c]), Elem<T>::load(orow[c]), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sD[r] = acc;
      sM[r] = r < n_q ? m[qrow + q0 + r] : 0.f;
      sL[r] = r < n_q ? fmaxf(l[qrow + q0 + r], 1e-30f) : 1.f;
      if (r < n_q) delta[qrow + q0 + r] = acc;
    }
  }
  __syncthreads();

  float mr[2], lr[2], dr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mr[hf] = sM[r0 + g + 8 * hf];
    lr[hf] = sL[r0 + g + 8 * hf];
    dr[hf] = sD[r0 + g + 8 * hf];
  }
  T* stg = sS + warp * 16 * LS;
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(Tk, q_base + q0 + BM) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(sK, kb + size_t(k0) * D, BN, Tk - k0, 1.f, false, tid,
                    NTH);
    load_tile<T, D>(sV, vb + size_t(k0) * D, BN, Tk - k0, 1.f, false, tid,
                    NTH);
    __syncthreads();

    // S = Q K^T, then p * (1 - tanh^2) (0 where masked)
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    WarpMma<T, NS, D, true>::run(s, sQ + r0 * LD, LD, sK, LD, lane);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[4 * j + e], fac = 1.f;
        if (softcap > 0.f) {
          const float th = tanhf(x / softcap);
          x = th * softcap;
          fac = 1.f - th * th;
        }
        const bool keep =
            row < Tq && col < Tk && (!causal || col <= q_base + row);
        s[4 * j + e] =
            keep ? expf(x - mr[e >> 1]) / lr[e >> 1] * fac : 0.f;
      }
    }
    // dP = dO V^T; ds = p (dp - delta), staged in T
    float dp[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) dp[i] = 0.f;
    WarpMma<T, NS, D, true>::run(dp, sdO + r0 * LD, LD, sV, LD, lane);
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) dp[i] = s[i] * (dp[i] - dr[(i & 3) >> 1]);
    stage<T, NS>(stg, LS, dp, lane);
    __syncwarp();
    // dq += ds K over this warp group's columns
    WarpMma<T, NO, BN, false>::run(acc, stg, LS, sK + c0, LD, lane);
  }
  store_rows<T, NO, D>(dq + qrow * D, acc, q0 + r0, Tq, c0, scale, lane);
}

// (b) dk and dv
template <typename T, int D>
__global__ void __launch_bounds__(128 * groups<D>())
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ m,
                     const float* __restrict__ l,
                     const T* __restrict__ dout,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
                     float scale, float softcap, int causal, int q_base) {
  constexpr int NW = 4 * groups<D>(), NTH = 32 * NW;
  constexpr int DV = D / groups<D>(), BN = bn_dkv<T, D>();
  constexpr int LD = D + pad<T>(), LS = BN + pad<T>();
  constexpr int NS = BN / 8, NO = DV / 8;
  static_assert(smem_bytes<T, D, BN, 0>() <= 232448, "shared memory");
  static_assert(BM % BN == 0, "query tiles align with key blocks");
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);  // BM x LD
  T* sV = sK + BM * LD;                     // BM x LD
  T* sQ = sV + BM * LD;                     // BN x LD, scaled q
  T* sdO = sQ + BN * LD;                    // BN x LD
  T* sS = sdO + BN * LD;                    // NW x 16 x LS, p then ds
  float* sM = reinterpret_cast<float*>(sS + NW * 16 * LS);
  float* sL = sM + BN;
  float* sD = sL + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * DV;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * BM;
  const size_t krow = size_t(bkv) * Tk;
  const float scale_t = Elem<T>::round(scale);

  load_tile<T, D>(sK, k + (krow + k0) * D, BM, Tk - k0, 1.f, false, tid,
                  NTH);
  load_tile<T, D>(sV, v + (krow + k0) * D, BM, Tk - k0, 1.f, false, tid,
                  NTH);
  T* stg = sS + warp * 16 * LS;
  float acc_k[NO * 4], acc_v[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc_k[i] = acc_v[i] = 0.f;

  // under causality no query before global position k0 sees these keys;
  // with q_base the shard's rows start at global position q_base, and a
  // block no row of the shard sees loops zero times and stores zeros
  const int q_begin = causal ? max(0, k0 - q_base) : 0;
  for (int hh = 0; hh < group; ++hh) {
    const size_t qrow = (size_t(b) * Hq + hk * group + hh) * Tq;
    for (int qs = q_begin; qs < Tq; qs += BN) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(sQ, q + (qrow + qs) * D, BN, Tq - qs, scale_t, true,
                      tid, NTH);
      load_tile<T, D>(sdO, dout + (qrow + qs) * D, BN, Tq - qs, 1.f, false,
                      tid, NTH);
      for (int i = tid; i < BN; i += NTH) {
        const bool in = qs + i < Tq;
        sM[i] = in ? m[qrow + qs + i] : 0.f;
        sL[i] = in ? fmaxf(l[qrow + qs + i], 1e-30f) : 1.f;
        sD[i] = in ? delta[qrow + qs + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T; p staged in T, p * (1 - tanh^2) kept (0 where masked)
      float st[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) st[i] = 0.f;
      WarpMma<T, NS, D, true>::run(st, sK + r0 * LD, LD, sQ, LD, lane);
      float p[NS * 4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + r0 + g + 8 * (e >> 1);
          const int ql = 8 * j + 2 * t + (e & 1);
          float x = st[4 * j + e], fac = 1.f;
          if (softcap > 0.f) {
            const float th = tanhf(x / softcap);
            x = th * softcap;
            fac = 1.f - th * th;
          }
          const bool keep = key < Tk && qs + ql < Tq &&
                            (!causal || key <= q_base + qs + ql);
          const float pr = keep ? expf(x - sM[ql]) / sL[ql] : 0.f;
          p[4 * j + e] = pr;
          st[4 * j + e] = pr * fac;
        }
      }
      stage<T, NS>(stg, LS, p, lane);
      __syncwarp();
      // dv += p^T dO
      WarpMma<T, NO, BN, false>::run(acc_v, stg, LS, sdO + c0, LD, lane);
      __syncwarp();  // the staging rows are rewritten below
      // dP^T = V dO^T; ds^T = p (dp - delta), staged in T
      float dpt[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) dpt[i] = 0.f;
      WarpMma<T, NS, D, true>::run(dpt, sV + r0 * LD, LD, sdO, LD, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - sD[ql]);
        }
      }
      stage<T, NS>(stg, LS, dpt, lane);
      __syncwarp();
      // dk += ds^T q_scaled
      WarpMma<T, NO, BN, false>::run(acc_k, stg, LS, sQ + c0, LD, lane);
    }
  }
  store_rows<T, NO, D>(dk + krow * D, acc_k, k0 + r0, Tk, c0, 1.f, lane);
  store_rows<T, NO, D>(dv + krow * D, acc_v, k0 + r0, Tk, c0, 1.f, lane);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* m, const float* l, const void* dout, void* dq,
           void* dk, void* dv, float* delta, int B, int Hq, int Hkv, int Tq,
           int Tk, float scale, float softcap, int causal, int q_base,
           cudaStream_t stream) {
  constexpr int NTH = 128 * groups<D>();
  const size_t smem_a = smem_bytes<T, D, bn_dq<T, D>(), 1>();
  const size_t smem_b = smem_bytes<T, D, bn_dkv<T, D>(), 0>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem_a));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem_b));
  if (err != cudaSuccess) return int(err);
  flash_bwd_dq_kernel<T, D>
      <<<dim3(B * Hq, (Tq + BM - 1) / BM), NTH, smem_a, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)o, m, l,
          (const T*)dout, (T*)dq, delta, Hq, Hkv, Tq, Tk, scale, softcap,
          causal, q_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  flash_bwd_dkv_kernel<T, D>
      <<<dim3(B * Hkv, (Tk + BM - 1) / BM), NTH, smem_b, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, m, l, (const T*)dout, delta,
          (T*)dk, (T*)dv, Hq, Hkv, Tq, Tk, scale, softcap, causal, q_base);
  return int(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const float* m, const float* l, const void* dout, void* dq,
             void* dk, void* dv, float* delta, int B, int Hq, int Hkv,
             int Tq, int Tk, int D, float scale, float softcap, int causal,
             int q_base, cudaStream_t s) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, m, l, dout, dq, dk, dv, delta, B, Hq,
                           Hkv, Tq, Tk, scale, softcap, causal, q_base, s);
    case 128:
      return launch<T, 128>(q, k, v, o, m, l, dout, dq, dk, dv, delta, B, Hq,
                            Hkv, Tq, Tk, scale, softcap, causal, q_base, s);
    case 256:
      return launch<T, 256>(q, k, v, o, m, l, dout, dq, dk, dv, delta, B, Hq,
                            Hkv, Tq, Tk, scale, softcap, causal, q_base, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, o, dout, dq: (B, Hq,
// Tq, D); k, v, dk, dv: (B, Hkv, Tk, D); m, l, delta: f32 (B, Hq, Tq), delta
// written by the first launch and read by the second.  q_base: the global
// position of query row 0 for the causal mask (a model rank's rows of the
// query-row split, whose m and l are its own forward's).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* m, const void* l,
                         const void* dout, void* dq, void* dk, void* dv,
                         void* delta, int B, int Hq, int Hkv, int Tq, int Tk,
                         int D, int dtype, int causal, float softcap,
                         float scale, int q_base, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, mf, lf, dout, dq, dk, dv, df, B, Hq,
                             Hkv, Tq, Tk, D, scale, softcap, causal, q_base,
                             s);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, mf, lf, dout, dq, dk, dv,
                                     df, B, Hq, Hkv, Tq, Tk, D, scale,
                                     softcap, causal, q_base, s);
    case 2:
      return launch_d<__half>(q, k, v, o, mf, lf, dout, dq, dk, dv, df, B,
                              Hq, Hkv, Tq, Tk, D, scale, softcap, causal,
                             q_base, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
