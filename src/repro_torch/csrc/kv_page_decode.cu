// KV-cache page decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kvcache/kernels.py
// (_decode_page_kernel / decode_page_indices_pallas) together with the XLA
// tail it leaves outside (codec.finish_pages_jnp: perm lookup and
// sign/mantissa fuse), and computes exactly what the reference's in-graph
// twin codec.decode_pages_jnp computes.  A page is 128 interleaved lane
// streams of S = ceil(n_elem / 128) symbols each; lane l decodes elements
// s * 128 + l, s = 0..S-1, in order, by the canonical rule
//   peek L bits -> length: the first length whose limit exceeds the peek (1
//   when none does, as the twin's argmax over all-false gives: the all-zero
//   tables of a never-written cold slot) -> index off + ((peek - first) >>
//   (L - length)), clamped into [0, n_sym - 1] -> symbol through the page's
//   perm -> element bits from the symbol and the raw sign/mantissa plane.
// L is 8 (fp8 pages, 16 symbols) or 12 (bf16 / f32 pages, 256 symbols).
//
// Bound on the H100: bytes (payload, sign/mantissa plane, tables and perm
// read once, the values written once).  The format fixes the work at S
// dependent rounds a lane (128 at the qwen3-8b page of 16,384 elements), and
// with a few hundred pages at most two or three CTAs share an SM, so a
// CTA's life -- its prologue plus S times the latency of one round -- is the
// kernel's time.  The design shortens both:
//   * one trip to device memory, before the loop: the page's payload
//     (stride x 128 bytes) and its whole sign/mantissa plane (16 KB for a
//     bf16 page, 48 KB f32, 8 KB fp8) arrive in shared memory by 16-byte
//     cp.async, so nothing in a round reads device memory.  The plane is
//     copied from the 16-byte granule that holds its first byte (a page's
//     plane starts at page * sm_bytes, which need not be aligned; a granule
//     never crosses an allocation);
//   * one shared-memory read a symbol: the CTA builds a (1 << L)-entry table
//     peek -> (symbol << 5) | length from the page's limits, firsts, offsets
//     and perm (8 KB of uint16 for L = 12, 32 entries a thread, filled one
//     code length's interval of peeks at a time) while the copies are in
//     flight, with exactly the rule above, so a never-written
//     slot and an index off the table decode as in the twin.  The symbol is
//     kept to its low 9 bits, all that the twin's fuse keeps ((sym << 7) &
//     0xFFFF, (sym << 23) & 0xFFFFFFFF, sym & 0xF);
//   * refills from words: the payload is transposed in place into big-endian
//     32-bit words of one lane (word w of lane l at [w][l], conflict-free),
//     one word past the end holding the clamped byte b[stride - 1] four
//     times.  A lane keeps a 64-bit window in two registers and, every two
//     symbols, adds the next word (the last one again once past the end)
//     when 32 or fewer bits are left, so a peek always sees at least 12
//     valid bits.  A round's dependent chain is then a shift, the table read
//     and a funnel shift: the refill is branch-free and its word is read a
//     check ahead.  The reference keeps a 32-bit window and adds up to two
//     bytes a round from b[min(byteptr, stride - 1)], byteptr = 4, 5, ...,
//     whenever 24 or fewer bits are left, so its peek too sees only valid
//     bits (more than 24).  Both windows hold the same byte sequence
//     b[min(k, stride - 1)], k = 0, 1, ..., consumed by the same lengths, so
//     both peeks are the top L bits of the same bit string and decode the
//     same symbols;
//   * stores: in round s the CTA writes elements s * 128 .. s * 128 + 127,
//     built in registers from the symbol and the staged plane byte(s).
// One CTA a page: splitting a page's lanes over 2 or 4 CTAs (each staging
// the page and building the table) can shorten only a CTA's prologue, not
// its rounds, and measured slower or no faster on the H100 (PERF.md).
//
// Two instances of the kernel, chosen by the wrapper from the page's shape
// (kvcache/kernels.py::instance), never on failure:
//   * staged (kStaged = true), the design above, for every page whose
//     payload words and plane fit the dynamic shared memory (kMaxDynSmem):
//     the qwen3-8b page of 16 positions in every cache dtype;
//   * streamed (kStaged = false), for larger pages (a bf16 page of 128
//     positions at qwen3-8b's widths needs 262,672 bytes staged): nothing
//     but the decode table and the perm goes to shared memory.  A lane
//     builds each 32-bit word from four bytes of its own payload column in
//     device memory (b[min(k, stride - 1)], the staged words' bytes, so
//     both instances decode the same symbols), read a refill check ahead as
//     in the staged loop, and each store reads its plane byte(s) from
//     device memory.  Each payload and plane byte is still read once, and
//     the 128 lanes of a CTA read 128 adjacent bytes, so the reads
//     coalesce; the page size has no limit.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kLanes = 128;
constexpr int kMaxSyms = 256;
// dynamic shared memory a block may use beside its static table and perm
// (9 KB) within the 227 KB of the H100
constexpr int kMaxDynSmem = 217 * 1024;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// 32-bit words a lane's transposed stream takes: ceil(stride / 4), then one
// word of the clamped byte b[stride - 1] that every later read gets
__host__ __device__ inline int words_per_lane(int stride) {
  return (stride + 3) / 4 + 1;
}
__host__ __device__ inline size_t smem_bytes(int stride, int sm_bytes) {
  return size_t(words_per_lane(stride)) * kLanes * 4 +
         ((size_t(sm_bytes) + 15) / 16 + 1) * 16;
}

// kind: 0 = fp8 (nibble plane), 1 = bf16 (1 byte), 2 = f32 (3 bytes)
template <int kKind>
struct Page;
template <>
struct Page<0> {
  using T = uint8_t;
  static constexpr int L = 8;
  static __device__ T make(uint32_t sym, const uint8_t* plane, int e) {
    const int packed = plane[e >> 1];
    const int nib = (e & 1) ? (packed & 0xF) : (packed >> 4);
    return T(((nib & 8) << 4) | ((sym & 0xF) << 3) | (nib & 7));
  }
};
template <>
struct Page<1> {
  using T = uint16_t;
  static constexpr int L = 12;
  static __device__ T make(uint32_t sym, const uint8_t* plane, int e) {
    const uint32_t b = plane[e];
    return T(((b & 0x80) << 8) | (sym << 7) | (b & 0x7F));
  }
};
template <>
struct Page<2> {
  using T = uint32_t;
  static constexpr int L = 12;
  static __device__ T make(uint32_t sym, const uint8_t* plane, int e) {
    const uint8_t* p = plane + 3 * e;
    const uint32_t sm24 =
        (uint32_t(p[0]) << 16) | (uint32_t(p[1]) << 8) | uint32_t(p[2]);
    return ((sm24 & 0x800000u) << 8) | (sym << 23) | (sm24 & 0x7FFFFFu);
  }
};

template <int kKind, bool kStaged>
__global__ void __launch_bounds__(kLanes)
kv_page_decode_kernel(const uint8_t* __restrict__ payload,
                      const uint8_t* __restrict__ signmant,
                      const int32_t* __restrict__ tables,
                      const int32_t* __restrict__ perm,
                      typename Page<kKind>::T* __restrict__ out, int stride,
                      int sm_bytes, int n_sym, int S, int n_elem) {
  constexpr int L = Page<kKind>::L;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint16_t s_tab[1 << L];  // peek -> (symbol << 5) | length
  __shared__ int s_perm[kMaxSyms];
  __shared__ int s_limit[L], s_first[L], s_offset[L];
  const int lane = threadIdx.x;
  const long long page = blockIdx.x;
  const int W = words_per_lane(stride);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem);
  uint8_t* s_plane_base = smem + size_t(W) * kLanes * 4;

  // 1. the page's perm and canonical tables (their loads in flight while
  // the copies are issued), then its payload (row p at p * 128) and its
  // plane, asynchronously
  const int32_t* tab = tables + page * 3 * L;
  for (int i = lane; i < n_sym; i += kLanes)
    s_perm[i] = perm[page * n_sym + i];
  if (lane < L) {
    s_limit[lane] = tab[lane];
    s_first[lane] = tab[L + lane];
    s_offset[lane] = tab[2 * L + lane];
  }
  const uint8_t* psrc = payload + page * stride * kLanes;
  const uint8_t* plane = signmant + page * sm_bytes;
  if constexpr (kStaged) {
    for (int i = lane; i < stride * (kLanes / 16); i += kLanes)
      cp_async16(smem + 16 * i, psrc + 16 * i);
    const uintptr_t a0 = reinterpret_cast<uintptr_t>(plane) & ~uintptr_t(15);
    const int granules =
        int((reinterpret_cast<uintptr_t>(plane + sm_bytes) - a0 + 15) >> 4);
    for (int i = lane; i < granules; i += kLanes)
      cp_async16(s_plane_base + 16 * i,
                 reinterpret_cast<const void*>(a0 + 16 * i));
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // 2. the decode table, while the copies are in flight
  __syncthreads();
  // The peeks whose first limit above them is limit j form the interval
  // [max of the limits before j, limit j), empty unless limit j exceeds
  // that maximum; above the largest limit the rule gives length 1.  So the
  // CTA fills the table one interval at a time, every thread a strided share
  // of it, and an entry costs no search.
  int lo_p = 0;
  for (int j = 0; j <= L; ++j) {
    const int hi_p = j < L ? min(max(lo_p, s_limit[j]), 1 << L) : 1 << L;
    const int length = j < L ? j + 1 : 1;
    const long long f = s_first[length - 1];
    const int o = s_offset[length - 1];
#pragma unroll 4
    for (int p = lo_p + lane; p < hi_p; p += kLanes) {
      long long idx = o + ((p - f) >> (L - length));
      idx = min(max(idx, 0ll), static_cast<long long>(n_sym - 1));
      s_tab[p] = uint16_t(((uint32_t(s_perm[idx]) & 0x1FF) << 5) | length);
    }
    lo_p = max(lo_p, hi_p);
  }
  if constexpr (kStaged) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();

  // 3. (staged) the payload, transposed in place into words of one lane,
  // eight words (raw rows 32c .. 32c + 31) at a time: a chunk is read whole
  // before any thread writes it, and no later chunk reads its rows
  if constexpr (kStaged) {
    const uint8_t* raw = smem + lane;
    const uint32_t last = raw[(stride - 1) * kLanes];
    for (int w0 = 0; w0 < W; w0 += 8) {
      uint32_t r[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t v = 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = 4 * (w0 + j) + k;
          v = (v << 8) | (p < stride ? uint32_t(raw[p * kLanes]) : last);
        }
        r[j] = v;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (w0 + j < W) s_words[(w0 + j) * kLanes + lane] = r[j];
      }
    }
    __syncthreads();
  }

  // 4. decode.  The window is hi:lo, its top `valid` bits the stream's
  // next bits and zeros below them.  A symbol's dependent chain is a shift
  // (the peek), one table read and one funnel shift, which takes the length
  // from the entry's low 5 bits.  A refill check every two symbols (at least
  // 32 valid bits after it, at most 24 consumed before the next) adds the
  // word read ahead of it, without a branch.
  const uint8_t* s_plane =
      kStaged ? s_plane_base + (reinterpret_cast<uintptr_t>(plane) & 15)
              : plane;
  // word w (< W) of this lane: staged, or built from device memory from the
  // same bytes b[min(4w + k, stride - 1)]
  const uint32_t* wl = s_words + lane;
  const uint8_t* pl = psrc + lane;
  auto word = [&](int w) -> uint32_t {
    if constexpr (kStaged) {
      return wl[w * kLanes];
    } else {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v = (v << 8) | uint32_t(__ldg(pl + min(4 * w + k, stride - 1) *
                                              kLanes));
      return v;
    }
  };
  uint32_t hi = word(0), lo = word(1), nw = word(min(2, W - 1));
  int next = 2, valid = 64;
  typename Page<kKind>::T* dst = out + page * n_elem;
  // four rounds an iteration; only a page whose S * 128 slots are not all
  // elements, or whose S is not a multiple of 4, checks each store
  auto rounds = [&](auto guarded) {
    constexpr bool kGuarded = decltype(guarded)::value;
    for (int s0 = 0; s0 < S; s0 += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k % 2 == 0) {
          const bool need = valid <= 32;  // then 9 <= valid <= 32
          hi |= need ? __funnelshift_rc(nw, 0u, valid) : 0u;
          lo |= need ? nw << (32 - valid) : 0u;
          next += need;
          valid += need ? 32 : 0;
          nw = word(min(next, W - 1));
        }
        const uint32_t ent = s_tab[hi >> (32 - L)];
        const int e = (s0 + k) * kLanes + lane;
        if (!kGuarded || (s0 + k < S && e < n_elem))
          dst[e] = Page<kKind>::make(ent >> 5, s_plane, e);
        hi = __funnelshift_l(lo, hi, ent);
        lo <<= ent & 31;
        valid -= int(ent & 31);
      }
    }
  };
  if (S % 4 == 0 && S * kLanes == n_elem) {
    rounds(std::false_type());
  } else {
    rounds(std::true_type());
  }
}

template <int kKind, bool kStaged>
int launch(const void* payload, const void* signmant, const void* tables,
           const void* perm, void* out, int n_pages, int stride, int sm_bytes,
           int max_len, int n_sym, int S, int n_elem, cudaStream_t stream) {
  auto kernel = kv_page_decode_kernel<kKind, kStaged>;
  if (max_len != Page<kKind>::L || n_sym > (1 << Page<kKind>::L))
    return int(cudaErrorInvalidValue);
  size_t smem = 0;
  if constexpr (kStaged) {
    smem = smem_bytes(stride, sm_bytes);
    if (smem > size_t(kMaxDynSmem)) return int(cudaErrorInvalidValue);
    // once per instance (thread-safe static initialisation), not per launch
    static const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
    if (attr != cudaSuccess) return int(attr);
  }
  kernel<<<n_pages, kLanes, smem, stream>>>(
      (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)tables, (const int32_t*)perm,
      (typename Page<kKind>::T*)out, stride, sm_bytes, n_sym, S, n_elem);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int kv_page_decode(const void* payload, const void* signmant,
                              const void* tables, const void* perm, void* out,
                              int n_pages, int stride, int sm_bytes,
                              int max_len, int n_sym, int sym_per_lane,
                              int n_elem, int kind, int staged,
                              void* stream) {
  if (n_pages < 1 || n_sym < 1 || n_sym > kMaxSyms || stride < 4 ||
      sm_bytes < 1 || sym_per_lane < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  const auto go = [&](auto fn) {
    return fn(payload, signmant, tables, perm, out, n_pages, stride,
              sm_bytes, max_len, n_sym, sym_per_lane, n_elem, st);
  };
  switch (kind * 2 + (staged ? 1 : 0)) {
    case 0:
      return go(launch<0, false>);
    case 1:
      return go(launch<0, true>);
    case 2:
      return go(launch<1, false>);
    case 3:
      return go(launch<1, true>);
    case 4:
      return go(launch<2, false>);
    case 5:
      return go(launch<2, true>);
    default:
      return int(cudaErrorInvalidValue);
  }
}
