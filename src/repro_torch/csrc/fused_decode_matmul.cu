// Fused ECF8 decode + matrix product for Hopper (sm_90a): y = x @ decode(W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_decode_matmul.py
// (_fused_kernel / _matmul_impl).  W (K, N) is fp8 in the tiled ECF8 layout
// of encode_tiled: tile (tk, tn) of (S, 128) elements is chunk tk * TN + tn,
// element (k, n) at slot k, lane n.  No decoded tile ever reaches device
// memory: each CTA decodes its tiles into shared memory and multiplies them
// there.
//
// One CTA owns one 128-column strip tn, a block of MB rows of x and a range
// of tiles along K (grid TN x ceil(M / MB) x n_split).  For every tile:
//   1. stage the chunk's payload (stride x 128 bytes), its sign/mantissa
//      nibbles (S x 64 bytes) and the x block (MB x S, bf16, transposed so
//      that one slot's MB rows are contiguous) in shared memory, so that
//      the decode's dependent rounds read no device memory (with one or
//      two CTAs an SM, a device load per round left the decode
//      latency-bound);
//   2. 128 threads, one per lane, run the reference's symbol loop over the
//      S slots (peek 8 bits -> canonical length, 0 when no limit exceeds
//      the peek -> symbol through perm, 0 off the table -> fp8 byte
//      ((sm&8)<<4)|(sym<<3)|(sm&7), high nibble first -> shift, refill one
//      byte from min(byteptr, stride-1)) and write the tile as bf16 (an
//      exact conversion through a 256-entry table) into shared memory;
//   3. each thread accumulates its column's MB outputs in f32 registers,
//      one fused multiply-add a row and slot (bf16 products are exact in
//      f32), the x values read as broadcasts.
// With n_split > 1 the K range is cut across CTAs (TN alone gives 32-96
// CTAs on the qwen3-8b shapes against 132 SMs); each split writes its
// partial sums to a workspace and a second kernel adds the splits in a fixed
// order, so two launches give the same bits (no float atomics).
//
// Bound on the H100: at M = 4 bytes (the compressed weight read once); at
// M = 512 operations.  This first version decodes with scalar integer code
// and multiplies with scalar f32 FMA (no tensor cores), and a CTA of 64 rows
// decodes its tiles again for each row block; wgmma / TMA are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t b) {
  return __uint_as_float(b << 16);
}

// e4m3fn byte -> bf16 bits; every finite e4m3fn value has at most four
// significant bits, so dropping the low half of its f32 bits is exact
__device__ uint16_t fp8_to_bf16_bits(int byte) {
  const int e = (byte >> 3) & 0xF, m = byte & 7;
  uint32_t bits;
  if (e == 15 && m == 7) {
    bits = 0x7FC00000u;
  } else {
    bits = __float_as_uint(e ? ldexpf(float(8 + m), e - 10)
                             : ldexpf(float(m), -9));
  }
  return uint16_t((bits >> 16) | ((byte & 0x80) << 8));
}

template <int MB>
__global__ void __launch_bounds__(kLanes)
fused_decode_matmul_kernel(const uint16_t* __restrict__ x,
                           const uint8_t* __restrict__ payload,
                           const uint8_t* __restrict__ signmant,
                           const int32_t* __restrict__ lj_limit,
                           const int32_t* __restrict__ first_lj,
                           const int32_t* __restrict__ offset,
                           const int32_t* __restrict__ perm,
                           float* __restrict__ out, int M, int K, int N,
                           int S, int stride, int n_tk, int tk_per_split) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* s_w = reinterpret_cast<uint16_t*>(smem);        // S x 128 bf16
  uint16_t* s_x = s_w + S * kLanes;                         // S x MB bf16
  uint8_t* s_pay = reinterpret_cast<uint8_t*>(s_x + S * MB);  // stride x 128
  uint8_t* s_sm = s_pay + stride * kLanes;                  // S x 64 nibbles
  __shared__ int s_limit[8], s_first[8], s_offset[8], s_perm[16];
  __shared__ uint16_t s_lut[256];

  const int lane = threadIdx.x;
  const int tn = blockIdx.x, TN = gridDim.x;
  const int m0 = blockIdx.y * MB;
  const int tk0 = blockIdx.z * tk_per_split;
  const int tk1 = min(n_tk, tk0 + tk_per_split);
  if (lane < 8) {
    s_limit[lane] = lj_limit[lane];
    s_first[lane] = first_lj[lane];
    s_offset[lane] = offset[lane];
  }
  if (lane < 16) s_perm[lane] = perm[lane];
  s_lut[lane] = fp8_to_bf16_bits(lane);
  s_lut[lane + kLanes] = fp8_to_bf16_bits(lane + kLanes);

  float acc[MB];
#pragma unroll
  for (int m = 0; m < MB; ++m) acc[m] = 0.f;

  for (int tk = tk0; tk < tk1; ++tk) {
    __syncthreads();   // the previous tile's readers are done
    const long long chunk = (long long)tk * TN + tn;
    const uint4* src =
        reinterpret_cast<const uint4*>(payload + chunk * stride * kLanes);
    uint4* dst = reinterpret_cast<uint4*>(s_pay);
    for (int i = lane; i < stride * (kLanes / 16); i += kLanes) dst[i] = src[i];
    const uint4* sm_src =
        reinterpret_cast<const uint4*>(signmant + chunk * (S * kLanes / 2));
    uint4* sm_dst = reinterpret_cast<uint4*>(s_sm);
    for (int i = lane; i < S * (kLanes / 32); i += kLanes) sm_dst[i] = sm_src[i];
    for (int i = lane; i < MB * S; i += kLanes) {
      const int m = i / S, s = i - m * S, row = m0 + m;
      s_x[s * MB + m] =
          row < M ? x[(long long)row * K + (long long)tk * S + s] : 0;
    }
    __syncthreads();

    // decode the tile: lane `lane` owns column tn * 128 + lane
    uint32_t win = (uint32_t(s_pay[lane]) << 24) |
                   (uint32_t(s_pay[kLanes + lane]) << 16) |
                   (uint32_t(s_pay[2 * kLanes + lane]) << 8) |
                   uint32_t(s_pay[3 * kLanes + lane]);
    int byteptr = 4, bits_valid = 32;
    for (int s = 0; s < S; ++s) {
      const int peek = int(win >> 24);
      int length = 0;
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (peek < s_limit[j]) length = j + 1;
      }
      const int idx = length ? s_offset[length - 1] +
                                   ((peek - s_first[length - 1]) >> (8 - length))
                             : 0;
      const int sym = (idx >= 0 && idx < 16) ? s_perm[idx] : 0;
      const int e = s * kLanes + lane;
      const int packed = s_sm[e >> 1];
      const int nib = (e & 1) ? (packed & 0xF) : (packed >> 4);
      const int byte = (((nib & 8) << 4) | (sym << 3) | (nib & 7)) & 0xFF;
      s_w[e] = s_lut[byte];
      win <<= length;
      bits_valid -= length;
      if (bits_valid <= 24) {
        const int p = min(byteptr, stride - 1);
        win |= uint32_t(s_pay[p * kLanes + lane]) << (24 - bits_valid);
        ++byteptr;
        bits_valid += 8;
      }
    }
    __syncthreads();

    // product: acc[m] += x[m0 + m, tk * S + s] * W[tk * S + s, column]
    for (int s = 0; s < S; ++s) {
      const float w = bf16_bits_to_float(s_w[s * kLanes + lane]);
      const uint2* xr = reinterpret_cast<const uint2*>(s_x + s * MB);
#pragma unroll
      for (int q = 0; q < MB / 4; ++q) {
        const uint2 v = xr[q];
        acc[4 * q + 0] = fmaf(bf16_bits_to_float(v.x & 0xFFFF), w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(bf16_bits_to_float(v.x >> 16), w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(bf16_bits_to_float(v.y & 0xFFFF), w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(bf16_bits_to_float(v.y >> 16), w, acc[4 * q + 3]);
      }
    }
  }

  // one split writes `out` directly; several write their slice of the
  // workspace (split z at z * M * N)
  float* dst = out + (long long)blockIdx.z * M * N;
  const int col = tn * kLanes + lane;
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    if (m0 + m < M) dst[(long long)(m0 + m) * N + col] = acc[m];
  }
}

__global__ void reduce_splits_kernel(const float* __restrict__ ws,
                                     float* __restrict__ out, int n_split,
                                     long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < n_split; ++k) s += ws[k * n + i];
  out[i] = s;
}

template <int MB>
int launch(const void* x, const void* payload, const void* signmant,
           const void* lj_limit, const void* first_lj, const void* offset,
           const void* perm, float* dst, int M, int K, int N, int S,
           int stride, int n_split, int tk_per_split, cudaStream_t stream) {
  const size_t smem = size_t(S) * kLanes * 2 + size_t(S) * MB * 2 +
                      size_t(stride) * kLanes + size_t(S) * kLanes / 2;
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_matmul_kernel<MB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(N / kLanes, (M + MB - 1) / MB, n_split);
  fused_decode_matmul_kernel<MB><<<grid, kLanes, smem, stream>>>(
      (const uint16_t*)x, (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)lj_limit, (const int32_t*)first_lj,
      (const int32_t*)offset, (const int32_t*)perm, dst, M, K, N, S, stride,
      K / S, tk_per_split);
  return int(cudaGetLastError());
}

}  // namespace

// x: (M, K) bf16; payload (TK, TN, stride, 128) u8; signmant (TK, TN, S*64)
// u8; tables (8,) and perm (16,) int32; out (M, N) f32; workspace
// (n_split, M, N) f32 when n_split > 1.  mb is the row block (8 or 64).
extern "C" int fused_decode_matmul(const void* x, const void* payload,
                                   const void* signmant, const void* lj_limit,
                                   const void* first_lj, const void* offset,
                                   const void* perm, void* out,
                                   void* workspace, int M, int K, int N,
                                   int S, int stride, int mb, int n_split,
                                   int tk_per_split, void* stream) {
  if (M < 1 || S < 4 || K % S || N % kLanes || stride < 4 || n_split < 1 ||
      tk_per_split < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = n_split > 1 ? (float*)workspace : (float*)out;
  int err;
  if (mb == 8) {
    err = launch<8>(x, payload, signmant, lj_limit, first_lj, offset, perm,
                    dst, M, K, N, S, stride, n_split, tk_per_split, st);
  } else if (mb == 64) {
    err = launch<64>(x, payload, signmant, lj_limit, first_lj, offset, perm,
                     dst, M, K, N, S, stride, n_split, tk_per_split, st);
  } else {
    return int(cudaErrorInvalidValue);
  }
  if (err || n_split == 1) return err;
  const long long n = (long long)M * N;
  reduce_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)workspace, (float*)out, n_split, n);
  return int(cudaGetLastError());
}
