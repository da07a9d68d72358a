// ECF8-TPU weight decode for Hopper (sm_90a), writing the caller's dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ecf8_decode.py
// (_decode_chunk_kernel / decode_pallas) and computes exactly what the
// reference's in-graph decode (_decode_jnp_impl) computes, followed by the
// reference's astype to the weight's dtype (src/repro/core/store.py, where
// XLA fuses the two).  One CTA of 64 threads decodes one chunk; thread t
// owns the interleaved lane streams 2t and 2t+1 and runs sym_per_lane
// rounds of, for each of its two lanes,
//   peek 8 bits -> (symbol, length) by the canonical rule (the first
//   length whose limit exceeds the peek, the symbol through perm) -> the
//   output value of the fp8 byte ((sm&8)<<4)|(sym<<3)|(sm&7) -> shift,
//   refill from min(byteptr, stride-1) (see the loop for why refilling 32
//   bits at once decodes the same symbols as the reference's one byte).
//
// Bound on the H100: bytes (payload + nibbles read once, the output written
// once: 1 byte an element for fp8 bits, 2 for bf16 / fp16, 4 for f32).
// What the design does about it:
//   * nothing in a round's dependency chain touches device memory: the
//     chunk's payload (stride x 128 bytes) and its sign/mantissa nibbles
//     (sym_per_lane x 64 bytes, 16 KB at S = 256) arrive in shared memory
//     by 16-byte cp.async, the nibbles of the second half of the rounds in
//     a second group that the loop waits for only when it gets there; the
//     payload is transposed in place into big-endian 32-bit words of one
//     lane each (the reference's clamp to byte stride-1 written into the
//     words), so that a refill is one conflict-free 32-bit read.  At
//     qwen3-8b's wq (512 chunks, four CTAs an SM, all in one wave) the
//     kernel's time is one CTA's life, so the latency before the first
//     round counts: it is one trip to device memory;
//   * the loop is bound by issue of shared-memory instructions and by the
//     integer pipe, not by bytes.  With the 8 canonical limits, firsts,
//     offsets and perm in registers (this design's first version) the
//     compare / select chain cost ~60 integer instructions a symbol; so the
//     CTA builds two 256-entry tables in shared memory from them, peek ->
//     (symbol, length) and (symbol, nibble) -> output value, and a symbol
//     costs two table reads and a 64-bit shift; two lanes a thread share
//     one nibble byte and one store of two neighbouring elements, and the
//     64-bit window is refilled 32 bits at a time, checked every four
//     symbols;
//   * the nibble window is copied from the 16-byte granule that holds the
//     chunk's first nibble byte: a layer slice of a stacked container
//     starts at i * ceil(n/2) bytes, which need not be 16-byte aligned, and
//     the copy reads only granules that hold a byte of the chunk (the bytes
//     around them in a granule are never used, and a granule never crosses
//     a page), so any alignment decodes;
//   * e4m3fn -> bf16 / fp16 / f32 is exact and done here, so no separate
//     cast kernel follows the decode (0x7F / 0xFF are NaN, 0x80 is -0.0;
//     the f32 value is built as c10 builds it and rounded with the same
//     intrinsics as PyTorch's CUDA cast);
//   * stores are coalesced: in each round a warp writes 64 consecutive
//     elements, two a thread in one store.
// A persistent grid that walked the chunks with a two-stage ring of
// staged bytes ran 3-16 % slower than one CTA a chunk at wi_gate and
// embed (chip_smoke.py phase 2, PERF.md), so the grid is one CTA a chunk.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = kLanes / 2;  // two lanes a thread
// dynamic shared memory a block may use beside its two tables (<= 1.25 KB)
// within the 227 KB of the H100
constexpr int kMaxDynSmem = 225 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// e4m3fn byte -> f32, exact; NaN as c10::Float8_e4m3fn -> float gives it
__device__ __forceinline__ float fp8_to_f32(int b) {
  const int e = (b >> 3) & 0xF, m = b & 7;
  uint32_t mag;
  if (e == 15 && m == 7) {
    mag = 0x7FF00000u;
  } else if (e) {
    mag = (uint32_t(e + 120) << 23) | (uint32_t(m) << 20);
  } else {
    mag = __float_as_uint(float(m) * (1.0f / 512.0f));
  }
  return __uint_as_float(mag | (uint32_t(b & 0x80) << 24));
}

// output element types by their bits (the table and the stores use the bit
// type, so no class type sits in shared memory); P holds two elements
template <int OUT>
struct Out;
template <>
struct Out<0> {  // fp8 bits
  using B = uint8_t;
  using P = uint16_t;
  static __device__ B from_byte(int b) { return B(b); }
};
template <>
struct Out<1> {  // bfloat16
  using B = uint16_t;
  using P = uint32_t;
  static __device__ B from_byte(int b) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(fp8_to_f32(b)));
  }
};
template <>
struct Out<2> {  // float16
  using B = uint16_t;
  using P = uint32_t;
  static __device__ B from_byte(int b) {
    return __half_as_ushort(__float2half_rn(fp8_to_f32(b)));
  }
};
template <>
struct Out<3> {  // float32
  using B = uint32_t;
  using P = uint64_t;
  static __device__ B from_byte(int b) {
    return __float_as_uint(fp8_to_f32(b));
  }
};

// 32-bit words a lane's transposed stream takes: ceil(stride / 4), then
// one word of the clamped byte b[stride-1] that every later read gets
__host__ __device__ inline int words_per_lane(int stride) {
  return (stride + 3) / 4 + 1;
}
__host__ __device__ inline size_t smem_bytes(int stride, int S) {
  return size_t(words_per_lane(stride)) * kLanes * 4 +
         size_t(S) * (kLanes / 2) + 16;
}

template <int OUT>
__global__ void __launch_bounds__(kThreads)
ecf8_decode_kernel(const uint8_t* __restrict__ payload,
                   const uint8_t* __restrict__ signmant,
                   const int32_t* __restrict__ lj_limit,
                   const int32_t* __restrict__ first_lj,
                   const int32_t* __restrict__ offset,
                   const int32_t* __restrict__ perm,
                   typename Out<OUT>::B* __restrict__ out, int stride,
                   int S, long long n_elem) {
  using T = typename Out<OUT>::B;
  using P = typename Out<OUT>::P;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint8_t s_dec[256];  // peek -> (symbol << 4) | length
  __shared__ T s_out[256];        // (symbol << 4) | nibble -> output value
  const int t = threadIdx.x;
  const long long c = blockIdx.x;
  const int W = words_per_lane(stride);
  // word w of lane 2t at [w][t], of lane 2t+1 at [w][64 + t]
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_nib_base = smem + size_t(W) * kLanes * 4;

  // 1. asynchronously, in two groups: the payload (into the words region,
  // row p at p * 128: block w of words covers rows 4w..4w+3) and the
  // nibbles of the first rounds, then the other nibbles, which the loop
  // waits for only when it reaches them
  const long long b0 = c * S * (kLanes / 2);
  const long long b1 = min(b0 + S * (kLanes / 2), (n_elem + 1) / 2);
  const uintptr_t a0 =
      reinterpret_cast<uintptr_t>(signmant + b0) & ~uintptr_t(15);
  const int granules =
      int((reinterpret_cast<uintptr_t>(signmant + b1) - a0 + 15) >> 4);
  // rounds below half_round need only granules below 4 * half_round + 1
  const int half_round = ((S / 2 + 3) / 4) * 4;
  const int split = min(granules, 4 * half_round + 1);
  {
    const uint8_t* psrc = payload + c * stride * kLanes;
    for (int i = t; i < stride * (kLanes / 16); i += kThreads)
      cp_async16(smem + 16 * i, psrc + 16 * i);
  }
  for (int i = t; i < split; i += kThreads)
    cp_async16(s_nib_base + 16 * i,
               reinterpret_cast<const void*>(a0 + 16 * i));
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = split + t; i < granules; i += kThreads)
    cp_async16(s_nib_base + 16 * i,
               reinterpret_cast<const void*>(a0 + 16 * i));
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. the decode tables, from the canonical tables held in registers (perm
  // staged in shared memory first, so that no global load waits on
  // another): the first length whose limit exceeds the peek (the limits
  // are nondecreasing; none -> length 1, as argmax over all-false gives),
  // the symbol through perm, 0 for an out-of-table index (only on bits past
  // the lane's stream; the value the reference's jnp.take fill gives)
  __shared__ int s_perm[16];
  if (t < 16) s_perm[t] = perm[t] & 0xF;
  int lim[8], fst[8], off[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lim[j] = lj_limit[j];
    fst[j] = first_lj[j];
    off[j] = offset[j];
  }
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 256 / kThreads; ++h) {
    const int peek = t + h * kThreads;
    int length = 1, o = off[0], f = fst[0];
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (peek < lim[j]) {
        length = j + 1;
        o = off[j];
        f = fst[j];
      }
    }
    const int idx = o + ((peek - f) >> (8 - length));
    const int sym = unsigned(idx) < 16u ? s_perm[idx] : 0;
    s_dec[peek] = uint8_t((sym << 4) | length);
    const int nib = peek & 0xF, sy = peek >> 4;
    s_out[peek] = Out<OUT>::from_byte(((nib & 8) << 4) | (sy << 3) |
                                      (nib & 7));
  }

  // 3. the payload, transposed in place into big-endian words of one lane:
  // byte k of lane l is b[min(k, stride-1)], so every word from W-1 on is
  // the clamped byte repeated.  Block w is read whole before any thread
  // writes it.
  const uint8_t* raw = smem + 2 * t;
  const uint32_t last =
      *reinterpret_cast<const uint16_t*>(raw + (stride - 1) * kLanes);
  for (int w = 0; w < W; ++w) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * w + k;
      const uint32_t v =
          p < stride ? *reinterpret_cast<const uint16_t*>(raw + p * kLanes)
                     : last;
      lo = (lo << 8) | (v & 0xFF);
      hi = (hi << 8) | (v >> 8);
    }
    __syncthreads();
    s_words[w * kLanes + t] = lo;
    s_words[w * kLanes + kThreads + t] = hi;
  }
  __syncthreads();

  // 4. decode.  A 64-bit window a lane, refilled 32 bits at a time whenever
  // 32 or fewer bits are left and checked once every 4 symbols (<= 32
  // bits): every peek sees 8 valid bits.  The reference refills one byte a
  // round from the same byte sequence b[min(k, stride-1)], k = 4, 5, ...,
  // and peeks the same top 8 bits, so both decode the same symbols.
  const uint8_t* s_nib =
      s_nib_base + (reinterpret_cast<uintptr_t>(signmant + b0) & 15) + t;
  const uint32_t* wa = s_words + t;
  const uint32_t* wb = s_words + kThreads + t;
  uint64_t win_a = (uint64_t(wa[0]) << 32) | wa[kLanes];
  uint64_t win_b = (uint64_t(wb[0]) << 32) | wb[kLanes];
  int next_a = 2, next_b = 2, valid_a = 64, valid_b = 64;
  const long long base = c * S * kLanes + 2 * t;  // this thread's first
  P* dst = reinterpret_cast<P*>(out + base);
  auto rounds = [&](auto guarded) {
    constexpr bool kGuarded = decltype(guarded)::value;
    for (int s0 = 0; s0 < S; s0 += 4) {
      if (s0 == half_round) {  // the second group of nibbles
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();
      }
      if (valid_a <= 32) {
        win_a |= uint64_t(wa[min(next_a, W - 1) * kLanes]) << (32 - valid_a);
        ++next_a;
        valid_a += 32;
      }
      if (valid_b <= 32) {
        win_b |= uint64_t(wb[min(next_b, W - 1) * kLanes]) << (32 - valid_b);
        ++next_b;
        valid_b += 32;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = s0 + k;
        const int ea = s_dec[uint32_t(win_a >> 56)];
        const int eb = s_dec[uint32_t(win_b >> 56)];
        const long long e = base + (long long)s * kLanes;
        if (!kGuarded || (s < S && e < n_elem)) {
          const int nb = s_nib[s * (kLanes / 2)];  // lane 2t: high nibble
          const T va = s_out[(ea & 0xF0) | (nb >> 4)];
          const T vb = s_out[(eb & 0xF0) | (nb & 0xF)];
          if (!kGuarded || e + 1 < n_elem) {
            dst[s * (kLanes / 2)] = P(va) | (P(vb) << (8 * sizeof(T)));
          } else {
            out[e] = va;
          }
        }
        win_a <<= (ea & 0xF);
        win_b <<= (eb & 0xF);
        valid_a -= ea & 0xF;
        valid_b -= eb & 0xF;
      }
    }
  };
  if (S % 4 == 0 && (c + 1) * S * kLanes <= n_elem) {
    rounds(std::false_type());
  } else {
    rounds(std::true_type());
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // none in flight
}

template <int OUT>
int launch(const void* payload, const void* signmant, const void* lj_limit,
           const void* first_lj, const void* offset, const void* perm,
           void* out, int n_chunks, int stride, int S, long long n_elem,
           cudaStream_t stream) {
  auto kernel = ecf8_decode_kernel<OUT>;
  const size_t smem = smem_bytes(stride, S);
  if (smem > size_t(kMaxDynSmem)) return int(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  kernel<<<n_chunks, kThreads, smem, stream>>>(
      (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)lj_limit, (const int32_t*)first_lj,
      (const int32_t*)offset, (const int32_t*)perm,
      (typename Out<OUT>::B*)out, stride, S, n_elem);
  return int(cudaGetLastError());
}

}  // namespace

// out_type: 0 = uint8 fp8 bits, 1 = bfloat16, 2 = float16, 3 = float32
extern "C" int ecf8_decode(const void* payload, const void* signmant,
                           const void* lj_limit, const void* first_lj,
                           const void* offset, const void* perm, void* out,
                           int n_chunks, int stride, int sym_per_lane,
                           long long n_elem, int out_type, void* stream) {
  if (n_chunks < 1 || stride < 4 || sym_per_lane < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = (cudaStream_t)stream;
  const auto go = [&](auto fn) {
    return fn(payload, signmant, lj_limit, first_lj, offset, perm, out,
              n_chunks, stride, sym_per_lane, n_elem, s);
  };
  switch (out_type) {
    case 0:
      return go(launch<0>);
    case 1:
      return go(launch<1>);
    case 2:
      return go(launch<2>);
    case 3:
      return go(launch<3>);
    default:
      return int(cudaErrorInvalidValue);
  }
}
