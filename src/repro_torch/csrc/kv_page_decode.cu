// KV-cache page decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kvcache/kernels.py
// (_decode_page_kernel / decode_page_indices_pallas) together with the XLA
// tail it leaves outside (codec.finish_pages_jnp: perm lookup and
// sign/mantissa fuse), and computes exactly what the reference's in-graph
// twin codec.decode_pages_jnp computes.  One CTA decodes one page: 128
// threads, one per interleaved lane stream, each running
// S = ceil(n_elem / 128) rounds of
//   peek L bits -> canonical length (first limit above the peek; 1 when
//   none is, as the twin's argmax over all-false gives) -> canonical index
//   -> symbol through the page's perm (index clamped into the table) ->
//   element bits from the symbol and the raw sign/mantissa plane ->
//   shift, refill up to two bytes from min(byteptr, stride - 1).
// L is 8 (fp8 pages, 16 symbols) or 12 (bf16 / f32 pages, 256 symbols).
//
// Bound on the H100: bytes (payload, sign/mantissa plane, tables and perm
// read once, the values written once).  The page's payload (stride x 128
// bytes) is staged into shared memory with 16-byte coalesced loads, so the
// per-round refills are shared-memory reads; the page's tables and perm
// (<= 256 entries: one shared-memory load per symbol, where the TPU kernel
// leaves the 256-way select to XLA) sit beside it.  In round s thread
// `lane` writes element s*128 + lane, so each round's stores coalesce.
// Never-written cold slots (all-zero tables) decode in bounds to symbol
// perm[0] or perm[1], as in the twin; no caller reads them.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxLen = 12;
constexpr int kMaxSyms = 256;

// kind: 0 = fp8 (nibble plane), 1 = bf16 (1 byte), 2 = f32 (3 bytes)
template <int kKind>
__global__ void __launch_bounds__(kLanes)
kv_page_decode_kernel(const uint8_t* __restrict__ payload,
                      const uint8_t* __restrict__ signmant,
                      const int32_t* __restrict__ tables,
                      const int32_t* __restrict__ perm,
                      void* __restrict__ out, int stride, int sm_bytes,
                      int max_len, int n_sym, int sym_per_lane,
                      int n_elem) {
  extern __shared__ __align__(16) uint8_t s_payload[];
  __shared__ int s_limit[kMaxLen], s_first[kMaxLen], s_offset[kMaxLen];
  __shared__ int s_perm[kMaxSyms];
  const int lane = threadIdx.x;
  const long long page = blockIdx.x;
  const int32_t* tab = tables + page * 3 * max_len;
  if (lane < max_len) {
    s_limit[lane] = tab[lane];
    s_first[lane] = tab[max_len + lane];
    s_offset[lane] = tab[2 * max_len + lane];
  }
  for (int i = lane; i < n_sym; i += kLanes) s_perm[i] = perm[page * n_sym + i];
  const uint4* src =
      reinterpret_cast<const uint4*>(payload + page * stride * kLanes);
  uint4* dst = reinterpret_cast<uint4*>(s_payload);
  for (int i = lane; i < stride * (kLanes / 16); i += kLanes) dst[i] = src[i];
  __syncthreads();

  const uint8_t* sm = signmant + page * sm_bytes;
  uint32_t win = (uint32_t(s_payload[lane]) << 24) |
                 (uint32_t(s_payload[kLanes + lane]) << 16) |
                 (uint32_t(s_payload[2 * kLanes + lane]) << 8) |
                 uint32_t(s_payload[3 * kLanes + lane]);
  int byteptr = 4, bits_valid = 32;
  for (int s = 0; s < sym_per_lane; ++s) {
    const int peek = int(win >> (32 - max_len));
    int length = 1;
    for (int j = max_len - 1; j >= 0; --j) {
      if (peek < s_limit[j]) length = j + 1;
    }
    int idx = s_offset[length - 1] +
              ((peek - s_first[length - 1]) >> (max_len - length));
    idx = min(max(idx, 0), n_sym - 1);
    const uint32_t sym = uint32_t(s_perm[idx]);
    const int e = s * kLanes + lane;
    if (e < n_elem) {
      if (kKind == 0) {
        const int packed = sm[e >> 1];
        const int nib = (e & 1) ? (packed & 0xF) : (packed >> 4);
        static_cast<uint8_t*>(out)[page * n_elem + e] =
            uint8_t(((nib & 8) << 4) | ((sym & 0xF) << 3) | (nib & 7));
      } else if (kKind == 1) {
        const uint32_t b = sm[e];
        static_cast<uint16_t*>(out)[page * n_elem + e] =
            uint16_t(((b & 0x80) << 8) | (sym << 7) | (b & 0x7F));
      } else {
        const uint32_t sm24 = (uint32_t(sm[3 * e]) << 16) |
                              (uint32_t(sm[3 * e + 1]) << 8) |
                              uint32_t(sm[3 * e + 2]);
        static_cast<uint32_t*>(out)[page * n_elem + e] =
            ((sm24 & 0x800000u) << 8) | (sym << 23) | (sm24 & 0x7FFFFFu);
      }
    }
    win <<= length;
    bits_valid -= length;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (bits_valid <= 24) {
        const int p = min(byteptr, stride - 1);
        win |= uint32_t(s_payload[p * kLanes + lane]) << (24 - bits_valid);
        ++byteptr;
        bits_valid += 8;
      }
    }
  }
}

template <int kKind>
int launch(const void* payload, const void* signmant, const void* tables,
           const void* perm, void* out, int n_pages, int stride, int sm_bytes,
           int max_len, int n_sym, int sym_per_lane, int n_elem,
           cudaStream_t stream) {
  const size_t smem = size_t(stride) * kLanes;
  cudaError_t err = cudaFuncSetAttribute(
      kv_page_decode_kernel<kKind>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kv_page_decode_kernel<kKind><<<n_pages, kLanes, smem, stream>>>(
      (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)tables, (const int32_t*)perm, out, stride, sm_bytes,
      max_len, n_sym, sym_per_lane, n_elem);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int kv_page_decode(const void* payload, const void* signmant,
                              const void* tables, const void* perm, void* out,
                              int n_pages, int stride, int sm_bytes,
                              int max_len, int n_sym, int sym_per_lane,
                              int n_elem, int kind, void* stream) {
  if (max_len < 1 || max_len > kMaxLen || n_sym < 1 || n_sym > kMaxSyms ||
      stride < 4)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return launch<0>(payload, signmant, tables, perm, out, n_pages, stride,
                       sm_bytes, max_len, n_sym, sym_per_lane, n_elem, st);
    case 1:
      return launch<1>(payload, signmant, tables, perm, out, n_pages, stride,
                       sm_bytes, max_len, n_sym, sym_per_lane, n_elem, st);
    case 2:
      return launch<2>(payload, signmant, tables, perm, out, n_pages, stride,
                       sm_bytes, max_len, n_sym, sym_per_lane, n_elem, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}
