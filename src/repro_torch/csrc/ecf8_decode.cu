// ECF8-TPU weight decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ecf8_decode.py
// (_decode_chunk_kernel / decode_pallas) and computes exactly what the
// reference's in-graph decode (_decode_jnp_impl) computes.  One CTA
// decodes one chunk: 128 threads, one per interleaved lane stream, each
// running sym_per_lane rounds of
//   peek 8 bits -> canonical length by compare against the 8 limits ->
//   symbol through perm -> fp8 byte ((sm&8)<<4)|(sym<<3)|(sm&7) ->
//   shift, refill at most one byte from min(byteptr, stride-1).
//
// Bound on the H100: bytes (payload + nibbles read once, fp8 bytes written
// once).  The chunk's payload (stride x 128 bytes, <= 32 KB) is staged into
// shared memory with 16-byte coalesced loads, so the per-round refills are
// shared-memory reads; the tables and perm sit in shared memory.  Every
// read of the flat nibble array and every write is bounded by n_elem.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;

__global__ void __launch_bounds__(kLanes)
ecf8_decode_kernel(const uint8_t* __restrict__ payload,
                   const uint8_t* __restrict__ signmant,
                   const int32_t* __restrict__ lj_limit,
                   const int32_t* __restrict__ first_lj,
                   const int32_t* __restrict__ offset,
                   const int32_t* __restrict__ perm,
                   uint8_t* __restrict__ out,
                   int stride, int sym_per_lane, long long n_elem) {
  extern __shared__ __align__(16) uint8_t s_payload[];
  __shared__ int s_limit[8], s_first[8], s_offset[8], s_perm[16];
  const int lane = threadIdx.x;
  const long long chunk = blockIdx.x;
  if (lane < 8) {
    s_limit[lane] = lj_limit[lane];
    s_first[lane] = first_lj[lane];
    s_offset[lane] = offset[lane];
  }
  if (lane < 16) s_perm[lane] = perm[lane];
  const uint4* src =
      reinterpret_cast<const uint4*>(payload + chunk * stride * kLanes);
  uint4* dst = reinterpret_cast<uint4*>(s_payload);
  for (int i = lane; i < stride * (kLanes / 16); i += kLanes) dst[i] = src[i];
  __syncthreads();

  uint32_t win = (uint32_t(s_payload[lane]) << 24) |
                 (uint32_t(s_payload[kLanes + lane]) << 16) |
                 (uint32_t(s_payload[2 * kLanes + lane]) << 8) |
                 uint32_t(s_payload[3 * kLanes + lane]);
  int byteptr = 4, bits_valid = 32;
  const long long base = chunk * sym_per_lane * kLanes + lane;
  for (int s = 0; s < sym_per_lane; ++s) {
    const int peek = int(win >> 24);
    // first length whose limit exceeds the peek (the limits are
    // nondecreasing); none -> length 1, as argmax over all-false gives
    int length = 1;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (peek < s_limit[j]) length = j + 1;
    }
    const int idx =
        s_offset[length - 1] + ((peek - s_first[length - 1]) >> (8 - length));
    // out-of-table index (only on bits past the lane's stream) -> symbol 0,
    // the value the reference's jnp.take fill gives after the uint8 cast
    const int sym = (idx >= 0 && idx < 16) ? s_perm[idx] : 0;
    const long long e = base + (long long)s * kLanes;
    if (e < n_elem) {
      const int packed = signmant[e >> 1];
      const int sm = (e & 1) ? (packed & 0xF) : (packed >> 4);
      out[e] = uint8_t(((sm & 8) << 4) | ((sym & 0xF) << 3) | (sm & 7));
    }
    win <<= length;
    bits_valid -= length;
    if (bits_valid <= 24) {
      const int p = min(byteptr, stride - 1);
      win |= uint32_t(s_payload[p * kLanes + lane]) << (24 - bits_valid);
      ++byteptr;
      bits_valid += 8;
    }
  }
}

}  // namespace

extern "C" int ecf8_decode(const void* payload, const void* signmant,
                           const void* lj_limit, const void* first_lj,
                           const void* offset, const void* perm, void* out,
                           int n_chunks, int stride, int sym_per_lane,
                           long long n_elem, void* stream) {
  const size_t smem = size_t(stride) * kLanes;
  ecf8_decode_kernel<<<n_chunks, kLanes, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)lj_limit, (const int32_t*)first_lj,
      (const int32_t*)offset, (const int32_t*)perm, (uint8_t*)out, stride,
      sym_per_lane, n_elem);
  return (int)cudaGetLastError();
}
