// Fused ECF8 decode + matrix product for Hopper (sm_90a): y = x @ decode(W).
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_decode_matmul.py
// (_fused_kernel / _matmul_impl).  W (K, N) is fp8 in the tiled ECF8 layout
// of encode_tiled: tile (tk, tn) of (S, 128) elements is chunk tk * TN + tn,
// element (k, n) at slot k, lane n.  No decoded tile ever reaches device
// memory: each CTA decodes its tiles into shared memory and multiplies them
// there on the tensor cores.
//
// One CTA owns one 128-column strip tn, a block of MB rows of x (8, 32, 128
// or 256) and a range of tiles along K (grid TN x ceil(M / MB) x n_split),
// so a tile is decoded ceil(M / 256) times a call at most (once for
// M <= 256).  Lane n of a tile decodes column n, k = 0 .. S-1 in order, so
// the decoded tile lands as W^T, K-major: row n holds its k-values.  That is
// the A operand of a warpgroup MMA, and x's rows, K-major too, are its B:
//   y^T (128 x MB) = W^T tile (128 x S) . x^T (S x MB),
// two m64 halves of wgmma.m64nNk16 (N = MB for one warpgroup, N = 128 for
// each of two warpgroups when MB = 256), f32 accumulators in registers.
// For every tile:
//   1. its payload (stride x 128 bytes) and sign/mantissa nibbles (S x 64
//      bytes) arrive by 16-byte cp.async one tile ahead, in a two-buffer
//      ring (one buffer when two do not fit the shared memory), and x's
//      block (MB x S bf16) at the start of the tile, rows past M
//      zero-filled, in the 128-byte-swizzled layout the descriptors name;
//   2. the payload is transposed in place into big-endian 32-bit words of
//      one lane (B1's design, csrc/ecf8_decode.cu), one word past the end
//      holding the clamped byte b[stride - 1] four times;
//   3. the first warpgroup decodes, one lane a thread (the tile's 128
//      columns), in sub-blocks of 64 k-values: a 64-bit window in two
//      registers, refilled 32 bits at a time every four symbols when 32 or
//      fewer bits are left, without a branch and from a word read a check
//      ahead, so that a symbol's dependent chain is a shift, one table read
//      and a funnel shift; one 4096-entry table that the CTA builds once
//      (the weight has one codebook), (peek, nibble) -> (bf16 bits, code
//      length), so a symbol costs one table read beside its nibble byte;
//      eight k-values of a column packed into one 16-byte store of the
//      swizzled row.  Two lanes a thread, as B1 decodes, and B1's two
//      256-entry tables (peek -> symbol and length; symbol and nibble ->
//      bf16) both measured slower on the H100 (PERF.md).  The reference
//      adds one byte a round from b[min(byteptr, stride - 1)] whenever 24
//      or fewer bits are left and peeks the top 8, so both windows hold the
//      same byte sequence b[min(k, stride - 1)], consumed by the same
//      lengths, and decode the same symbols.  The table follows the fused
//      reference kernel's rule: the first length whose limit exceeds the
//      peek, length 0 and index 0 when none does, symbol 0 for an index off
//      the table;
//   4. the sub-block's wgmma chain is issued asynchronously, and the
//      warpgroup goes on to decode the next sub-block into the other
//      buffer of a two-stage ring while the tensor cores multiply (one
//      buffer at 32 rows or fewer, where the product is short and a smaller
//      CTA lets more CTAs share an SM).
// A tile depth S that is not a multiple of the tensor cores' k-step of 16
// is padded in shared memory: the last sub-block's decoded columns past S
// are written as zeros, and so are x's matching k-values (read element by
// element when S is not a multiple of 8, where x's rows are not 16-byte
// aligned), so the padded products add exact zeros.
// With n_split > 1 the K range is cut across CTAs (TN alone gives 32-96
// CTAs on the qwen3-8b shapes against 132 SMs); each split writes its
// partial sums to a workspace and a second kernel adds the splits in a fixed
// order, so two launches give the same bits (no float atomics).  bf16
// products are exact in f32; only the order of the f32 sums differs from
// the plain version's.
//
// Bound on the H100: at M = 4 bytes (the compressed weight read once), at
// M = 512 operations.  What sets the pace is the decode: S dependent rounds
// a lane (~256 at S = 256), whose latency a CTA's 128 lanes cannot hide
// alone; small row blocks keep a CTA's shared memory small so that two or
// more CTAs share an SM, and the product overlaps the next sub-block's
// decode.
#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

constexpr int kLanes = 128;
constexpr int kSub = 64;  // k-values a sub-block: one 128-byte swizzled row
// dynamic shared memory a block may use beside its static tables (< 2 KB)
// within the 227 KB of the H100
constexpr int kMaxDynSmem = 225 * 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// writes of the generic proxy (st.shared, cp.async) made visible to the
// async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the accumulators are written by the tensor cores between a wgmma's issue
// and its wait: keep the compiler from moving their reads across the wait
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// shared-memory matrix descriptor, 128-byte swizzle, K-major: start
// address, leading byte offset 16 (unused), 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (1ull << 62);
}

// wgmma.m64nNk16, bf16 x bf16 -> f32, A and B K-major from shared memory,
// accumulating into d (N / 2 registers a thread)
template <int N>
struct Mma;
template <>
struct Mma<8> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Mma<32> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(1));
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};


__host__ __device__ inline int words_per_lane(int stride) {
  return (stride + 3) / 4 + 1;
}
// buffers of decoded sub-tiles: two (a ring, the product of one sub-block
// overlapping the decode of the next) where the product is worth
// overlapping; at 32 rows or fewer one, so that more CTAs share an SM
__host__ __device__ constexpr int a_buffers(int mb) { return mb <= 32 ? 1 : 2; }
// 1024 bytes of alignment slack, the A buffers, x's block, the payload /
// nibble buffers and the 4096-entry decode table
__host__ __device__ inline size_t smem_bytes(int S, int stride, int mb,
                                             int pbufs) {
  const size_t nkb = (S + kSub - 1) / kSub;
  return 1024 + a_buffers(mb) * kLanes * 128 + nkb * mb * 128 +
         size_t(pbufs) * (size_t(words_per_lane(stride)) * kLanes * 4 +
                          size_t(S) * (kLanes / 2)) +
         4096 * 4;
}

// One lane's bit window: hi:lo, its top `valid` bits the stream's next
// bits and zeros below them; nw the word the next refill adds.  A symbol's
// dependent chain is the peek, one table read and a funnel shift that takes
// the length from the entry's low 5 bits.
struct Window {
  const uint32_t* words;  // the lane's words, word w at [w * 128]
  uint32_t hi, lo, nw;
  int next, valid;
  __device__ void start(const uint32_t* w, int W) {
    words = w;
    hi = w[0];
    lo = w[kLanes];
    nw = w[min(2, W - 1) * kLanes];
    next = 2;
    valid = 64;
  }
  // at least 33 valid bits after a check, at most 32 consumed (four
  // symbols) before the next; no branch, the word read a check ahead
  __device__ void refill(int W) {
    const bool need = valid <= 32;  // then 1 <= valid <= 32
    hi |= need ? __funnelshift_rc(nw, 0u, valid) : 0u;
    lo |= need ? nw << (32 - valid) : 0u;
    next += need;
    valid += need ? 32 : 0;
    nw = words[min(next, W - 1) * kLanes];
  }
  __device__ uint32_t peek() const { return hi >> 24; }
  __device__ void consume(uint32_t e) {
    hi = __funnelshift_l(lo, hi, e);
    lo <<= e & 31;
    valid -= int(e & 31);
  }
};

template <int NW, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
fused_decode_matmul_kernel(const uint16_t* __restrict__ x,
                           const uint8_t* __restrict__ payload,
                           const uint8_t* __restrict__ signmant,
                           const int32_t* __restrict__ lj_limit,
                           const int32_t* __restrict__ first_lj,
                           const int32_t* __restrict__ offset,
                           const int32_t* __restrict__ perm,
                           float* __restrict__ out, int M, int K, int N,
                           int S, int stride, int n_tk, int tk_per_split,
                           int pbufs) {
  constexpr int MB = NW * NWG;  // rows of x a CTA
  constexpr int NT = 128 * NWG;
  constexpr int AB = a_buffers(MB);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const s_a =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nkb = (S + kSub - 1) / kSub;
  uint8_t* const s_x = s_a + AB * kLanes * 128;  // [kb][row] 128-byte rows
  const int W = words_per_lane(stride);
  const int pbytes = W * kLanes * 4 + S * (kLanes / 2);
  uint8_t* const s_p = s_x + nkb * MB * 128;  // [buf]: words, nibbles
  // (peek << 4) | nibble -> (bf16 bits << 16) | length, built from the
  // two small tables below once a CTA
  uint32_t* const s_vl = reinterpret_cast<uint32_t*>(s_p + pbufs * pbytes);
  __shared__ uint16_t s_dec[256];  // peek -> (symbol << 8) | length
  __shared__ uint16_t s_out[256];  // (symbol << 4) | nibble -> bf16 bits
  __shared__ int s_perm[16];

  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, g = (tid % 32) / 4, tq = tid % 4;
  const int tn = blockIdx.x, TN = gridDim.x;
  const int m0 = blockIdx.y * MB;
  const int tk0 = blockIdx.z * tk_per_split;
  const int T = min(n_tk, tk0 + tk_per_split) - tk0;

  // the payload and nibbles of tile t into buffer buf
  auto load_p = [&](int t, int buf) {
    const long long chunk = (long long)(tk0 + t) * TN + tn;
    uint8_t* dst = s_p + buf * pbytes;
    const uint8_t* ps = payload + chunk * stride * kLanes;
    for (int i = tid; i < stride * (kLanes / 16); i += NT)
      cp_async16(dst + 16 * i, ps + 16 * i, 16);
    const uint8_t* ns = signmant + chunk * (S * (kLanes / 2));
    uint8_t* nd = dst + W * kLanes * 4;
    for (int i = tid; i < S * (kLanes / 32); i += NT)
      cp_async16(nd + 16 * i, ns + 16 * i, 16);
  };
  // x's block for tile t: row r, k-values 8c .. 8c+7 as 16-byte chunk c % 8
  // of sub-block c / 8, swizzled by r % 8; rows past M and k-values past S
  // (up to the next multiple of 16) zero
  const int S16 = (S + 15) / 16 * 16;
  auto load_x = [&](int t) {
    const int k0 = (tk0 + t) * S;
    if (S % 8 == 0) {
      const int chunks = S16 / 8;
      for (int i = tid; i < MB * chunks; i += NT) {
        const int r = i / chunks, c = i % chunks;
        const bool in = m0 + r < M && 8 * c < S;
        const uint16_t* src =
            in ? x + (long long)(m0 + r) * K + k0 + 8 * c : x;
        cp_async16(
            s_x + ((c / 8) * MB + r) * 128 + (((c % 8) ^ (r & 7)) << 4),
            src, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < MB * S16; i += NT) {
        const int r = i / S16, k = i % S16, c = k / 8;
        const bool in = m0 + r < M && k < S;
        *reinterpret_cast<uint16_t*>(
            s_x + ((c / 8) * MB + r) * 128 + (((c % 8) ^ (r & 7)) << 4) +
            2 * (k % 8)) = in ? x[(long long)(m0 + r) * K + k0 + k] : 0;
      }
    }
  };

  if (pbufs == 2) {
    load_p(0, 0);
    cp_async_commit();
  }

  // the decode tables, once a CTA (the reference's rule, see above)
  if (tid < 16) s_perm[tid] = perm[tid] & 0xF;
  int lim[8], fst[8], off[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    lim[j] = lj_limit[j];
    fst[j] = first_lj[j];
    off[j] = offset[j];
  }
  __syncthreads();
  for (int p = tid; p < 256; p += NT) {
    int length = 0, idx = 0;
#pragma unroll
    for (int j = 7; j >= 0; --j) {
      if (p < lim[j]) {
        length = j + 1;
        idx = off[j] + ((p - fst[j]) >> (7 - j));
      }
    }
    const int sym = (idx >= 0 && idx < 16) ? s_perm[idx] : 0;
    s_dec[p] = uint16_t((sym << 8) | length);
    s_out[p] = fp8_to_bf16_bits(((p & 8) << 4) | ((p >> 4) << 3) | (p & 7));
  }
  __syncthreads();
  for (int i = tid; i < 4096; i += NT) {
    const uint32_t d = s_dec[i >> 4];
    s_vl[i] =
        (uint32_t(s_out[((d >> 4) & 0xF0) | (i & 0xF)]) << 16) | (d & 31);
  }

  float acc[NW];  // m64 half h at acc[h * NW / 2]
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = 0.f;

  int q = 0;  // sub-blocks issued so far: A buffer q % AB
  for (int t = 0; t < T; ++t) {
    // every wgmma of the last tile is done before x's block is replaced
    wgmma_wait<0>();
    fence_acc<NW>(acc);
    __syncthreads();
    load_x(t);
    const int buf = pbufs == 2 ? (t & 1) : 0;
    if (pbufs == 1) {
      load_p(t, 0);
    } else if (t + 1 < T) {
      load_p(t + 1, buf ^ 1);
    }
    cp_async_commit();
    if (pbufs == 1) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();  // this tile's payload, not the next one's
    }
    __syncthreads();

    // the payload, transposed in place, eight words (raw rows 32c .. 32c +
    // 31) at a time: a chunk is read whole before any thread writes it, and
    // no later chunk reads its rows
    uint8_t* const pb = s_p + buf * pbytes;
    const bool decoder = tid < kLanes;
    uint32_t last = 0;
    if (decoder) last = pb[(stride - 1) * kLanes + tid];
    for (int w0 = 0; w0 < W; w0 += 8) {
      uint32_t r[8];
      if (decoder) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t v = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int p = 4 * (w0 + j) + k;
            v = (v << 8) | (p < stride ? uint32_t(pb[p * kLanes + tid]) : last);
          }
          r[j] = v;
        }
      }
      __syncthreads();
      if (decoder) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (w0 + j < W)
            reinterpret_cast<uint32_t*>(pb)[(w0 + j) * kLanes + tid] = r[j];
        }
      }
    }
    __syncthreads();

    // thread t of the first warpgroup decodes lane t
    const uint8_t* nib = pb + W * kLanes * 4 + (tid >> 1);
    const int nshift = (tid & 1) ? 0 : 4;  // even lanes: the high nibble
    Window w;
    if (decoder) w.start(reinterpret_cast<const uint32_t*>(pb) + tid, W);
    // the eight k-values 8c .. 8c + 7 of sub-block kb, packed into one
    // 16-byte store of the swizzled row; guarded: those past S are zero
    // (the entry 0 has bf16 bits 0 and length 0, so nothing is consumed)
    auto decode_chunk = [&](uint8_t* a, int kb, int c, auto guarded) {
      constexpr bool kGuarded = decltype(guarded)::value;
      uint32_t v[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w.refill(W);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = kb * kSub + 8 * c + 4 * h + j;
          // one table read: the peek and this lane's nibble give the
          // element's bf16 bits and the code's length
          uint32_t e;
          if (!kGuarded || s < S) {
            const uint32_t nb = nib[s * (kLanes / 2)] >> nshift;
            e = s_vl[((w.hi >> 20) & 0xFF0) | (nb & 0xF)];
          } else {
            e = 0u;
          }
          if (j & 1) {
            v[2 * h + j / 2] = __byte_perm(v[2 * h + j / 2], e, 0x7610);
          } else {
            v[2 * h + j / 2] = e >> 16;
          }
          w.consume(e);
        }
      }
      *reinterpret_cast<uint4*>(a + tid * 128 + ((c ^ (tid & 7)) << 4)) =
          make_uint4(v[0], v[1], v[2], v[3]);
    };
    for (int kb = 0; kb < nkb; ++kb, ++q) {
      const int kv = min(kSub, S - kb * kSub);  // real k-values
      const int kvp = (kv + 15) / 16 * 16;      // padded to the k-step
      uint8_t* const a = s_a + (q % AB) * (kLanes * 128);
      // the wgmma chains that read this buffer (sub-block q - AB) are done
      wgmma_wait<AB - 1>();
      fence_acc<NW>(acc);
      __syncthreads();
      if (decoder) {
        for (int c = 0; c < kv / 8; ++c)
          decode_chunk(a, kb, c, std::false_type());
        for (int c = kv / 8; c < kvp / 8; ++c)
          decode_chunk(a, kb, c, std::true_type());
      }
      if (kb == 0) cp_async_wait<0>();  // x's block for this tile
      fence_proxy_async();
      __syncthreads();
      // y^T += W^T (columns 64h .. 64h + 63) . x^T (this warpgroup's rows);
      // a k-step of 16 inside the 128-byte rows advances the start by 32 B
      wgmma_fence();
      const uint8_t* const xb = s_x + (kb * MB + wg * NW) * 128;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (int ks = 0; ks < kvp / 16; ++ks)
          Mma<NW>::ss(acc + h * (NW / 2),
                      gmma_desc(a + h * 64 * 128 + 32 * ks),
                      gmma_desc(xb + 32 * ks));
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
  fence_acc<NW>(acc);

  // element e of n-tile j of half h: column 64h + 16 warp + g + 8 (e >> 1)
  // of the strip, row 8j + 2 tq + (e & 1) of this warpgroup's x rows; one
  // split writes `out` directly, several their slice of the workspace
  float* dst = out + (long long)blockIdx.z * M * N + tn * kLanes;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * h + 16 * warp + g + 8 * (e >> 1);
        const int m = m0 + wg * NW + 8 * j + 2 * tq + (e & 1);
        if (m < M) dst[(long long)m * N + n] = acc[h * (NW / 2) + 4 * j + e];
      }
    }
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

template <int NW, int NWG>
int launch(const void* x, const void* payload, const void* signmant,
           const void* lj_limit, const void* first_lj, const void* offset,
           const void* perm, float* dst, int M, int K, int N, int S,
           int stride, int n_split, int tk_per_split, int pbufs,
           cudaStream_t stream) {
  auto kernel = fused_decode_matmul_kernel<NW, NWG>;
  const size_t smem = smem_bytes(S, stride, NW * NWG, pbufs);
  if (smem > size_t(kMaxDynSmem)) return int(cudaErrorInvalidValue);
  // once per instance (thread-safe static initialisation), not per launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxDynSmem);
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(N / kLanes, (M + NW * NWG - 1) / (NW * NWG), n_split);
  kernel<<<grid, 128 * NWG, smem, stream>>>(
      (const uint16_t*)x, (const uint8_t*)payload, (const uint8_t*)signmant,
      (const int32_t*)lj_limit, (const int32_t*)first_lj,
      (const int32_t*)offset, (const int32_t*)perm, dst, M, K, N, S, stride,
      K / S, tk_per_split, pbufs);
  return int(cudaGetLastError());
}

}  // namespace

// x: (M, K) bf16; payload (TK, TN, stride, 128) u8; signmant (TK, TN, S*64)
// u8; tables (8,) and perm (16,) int32; out (M, N) f32; workspace
// (n_split, M, N) f32 when n_split > 1.  mb is the row block (8, 32, 128 or
// 256), pbufs the payload buffers (1 or 2).
extern "C" int fused_decode_matmul(const void* x, const void* payload,
                                   const void* signmant, const void* lj_limit,
                                   const void* first_lj, const void* offset,
                                   const void* perm, void* out,
                                   void* workspace, int M, int K, int N,
                                   int S, int stride, int mb, int n_split,
                                   int tk_per_split, int pbufs,
                                   void* stream) {
  if (M < 1 || S < 1 || K % S || N % kLanes || stride < 4 ||
      n_split < 1 || tk_per_split < 1 || (pbufs != 1 && pbufs != 2))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = n_split > 1 ? (float*)workspace : (float*)out;
  const auto go = [&](auto fn) {
    return fn(x, payload, signmant, lj_limit, first_lj, offset, perm, dst, M,
              K, N, S, stride, n_split, tk_per_split, pbufs, st);
  };
  int err;
  switch (mb) {
    case 8:
      err = go(launch<8, 1>);
      break;
    case 32:
      err = go(launch<32, 1>);
      break;
    case 128:
      err = go(launch<128, 1>);
      break;
    case 256:
      err = go(launch<128, 2>);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  if (err || n_split == 1) return err;
  const long long n = (long long)M * N;
  reduce_splits_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      (const float*)workspace, (float*)out, n_split, n);
  return int(cudaGetLastError());
}
