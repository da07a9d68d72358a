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
// Only the order of the f32 sums and p * (1 - tanh^2) taken before the
// multiplication by (dp - delta) differ from the plain version, and, in
// bf16 / fp16, f32 bits before rounding: p = exp2(s log2(e) - (m log2(e) +
// log2(max(l, 1e-30)))) and tanh(y) = (1 - e) / (1 + e), e = exp2(-2 |y|
// log2(e)), both from the special-function unit (|error| ~1e-7 against
// the rounding of p to T at ~4e-3).
//
// Two launches on the caller's stream, deterministic, no atomics:
//   (a) dq: one CTA per (b * Hq + h, 64 query rows).  It computes delta for
//       its rows from dO and O (and writes it out for (b)), then loops over
//       the K/V tiles its rows can see, at absolute key positions 0, 64, ...
//       (so a q_base shard's rows sum in the unsharded launch's order);
//   (b) dk / dv: one CTA per (b * Hkv + hk, 128 keys; 64 at D = 256).  It
//       loops over every head of the GQA group and over the query tiles
//       that can see its keys, reading delta.
// S and dP are recomputed by both, so a visible (q, k) pair costs seven
// products of 2 * D flops against the bound's five: at most 5/7 of the
// operations bound.  In exchange dq needs no atomics, the gradients are
// the same bits on every launch, and each q_base shard's dq is the
// unsharded launch's rows bit for bit.
//
// Bound on the H100: operations (five products of 2 * D flops per visible
// (q, k) pair, 2.5x the forward's).  bf16 and fp16 run every product on
// Hopper's warpgroup MMA (wgmma, f32 accumulators in registers), as the
// forward kernel does:
//   (a) a warpgroup owns 64 query rows.  S = Q K^T and dP = dO V^T are
//       m64n64k16 chains with both operands K-major in 128-byte-swizzled
//       shared memory; the softmax recompute and ds = p (dp - delta) run on
//       the accumulator registers (while dP still multiplies), and ds,
//       rounded to T, is the register A operand of dq += dS K, K read
//       MN-major (the forward's O += P V).
//   (b) a warpgroup owns 64 keys, two warpgroups a CTA share each q / dO
//       tile.  S^T = K Q^T and dP^T = V dO^T come out directly (K and V as
//       the A tiles, q and dO K-major as B); P^T and dS^T, rounded to T,
//       are the register A operands of dv += P^T dO and dk += dS^T q, with
//       dO and q read MN-major.  The query tile is 64 rows at every D.
// The loop's tiles (K/V in (a); q, dO and their m, l, delta rows in (b))
// arrive by cp.async into a two-stage ring in the swizzled layout; once
// they land each thread scales the q chunks it copied (one packed multiply
// a pair, the same rounding) and turns its statistics into the exponent's
// offset, then one barrier a tile hands the stage to wgmma and lets the
// next tile's copies refill the other stage while this one multiplies.
// Rows past Tq get an offset of +inf, so p is 0 there without a test.
// D = 256: one warpgroup's f32 accumulators would not fit its registers,
// so both kernels split the output columns over two warpgroups that each
// compute S and dP (the forward's D = 256 split).  Giving one warpgroup of
// (b) dv and the other dk does one product less a tile, but measured
// slower: ptxas serialised the wgmma of its two divergent paths.
//
// f32 keeps the scalar path: fragments of 16 x 8 from scalar FMAs out of
// padded shared rows, p and ds staged through each warp's rows.  It is not
// on the bf16 training path, and its 1e-5 agreement needs full f32
// products, which TF32 tensor cores would break (as the forward's f32).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;  // rows a CTA owns: queries in (a), keys in (b)

// --------------------------------------------------------------------------
// bf16 / fp16: wgmma, cp.async ring (csrc/hopper.cuh)
// --------------------------------------------------------------------------

// warpgroups of a dq CTA: two at D = 256, each with half of dq's columns
template <int D>
__host__ __device__ constexpr int dq_groups() {
  return D > 128 ? 2 : 1;
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// 2^x on the special-function unit (results below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = (1 - e) / (1 + e) with e = exp(-2 |y|), the sign restored
__device__ __forceinline__ float tanh_ex2(float y) {
  const float e = ex2(-2.f * kLog2e * fabsf(y));
  return copysignf(__fdividef(1.f - e, 1.f + e), y);
}

// the 16-byte chunk at p (eight T) times s, each product rounded to T: one
// packed multiply a pair, the same bits as round(float(x) * float(s))
template <typename T>
struct Vec2;
template <>
struct Vec2<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ type splat(float x) { return __float2bfloat162_rn(x); }
};
template <>
struct Vec2<__half> {
  using type = __half2;
  static __device__ type splat(float x) { return __float2half2_rn(x); }
};
template <typename T>
__device__ __forceinline__ void scale_chunk(T* p,
                                            typename Vec2<T>::type s2) {
  uint4 raw = *reinterpret_cast<uint4*>(p);
  auto* e = reinterpret_cast<typename Vec2<T>::type*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) e[j] = __hmul2(e[j], s2);
  *reinterpret_cast<uint4*>(p) = raw;
}

// keeps the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// acc (64 x 64, f32: element e of n-tile j at 4j + e is row 16 * warp + g +
// 8 * (e >> 1), column 8j + 2t + (e & 1)) = A . B^T over D, A and B 64-row
// swizzled tiles read K-major: k-step ks reads columns 16ks..16ks+15, block
// ks / 4, 32 bytes a step within its 128-byte rows; 8-row groups 1024
// bytes apart
template <typename T, int D>
__device__ __forceinline__ void gemm_nt(float* acc, const T* A, const T* B) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int off = (ks >> 2) * (64 * 64) + (ks & 3) * 16;
    Wgmma<T>::ss_n64(acc, gmma_desc(A + off, 16, 1024),
                     gmma_desc(B + off, 16, 1024), ks > 0);
  }
}

// acc (64 x N, N = 64, 128 or 256: 128-column chunks at acc + 64 c) +=
// A . B[:, c0:c0 + N], A the 64 x 64 register operand a[kk] (k-step kk from
// the accumulator layout above, packed in pairs), B a 64-row swizzled tile
// read MN-major: keys (rows) 16kk..16kk+15 are two 8-row groups 1024 bytes
// apart, 64-column blocks 8 KB apart
template <typename T, int N>
__device__ __forceinline__ void gemm_rn(float* acc, uint32_t (*a)[4],
                                        const T* B, int c0) {
  constexpr int STEP = N == 64 ? 64 : 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int n = 0; n < N; n += STEP) {
      const uint64_t db = gmma_desc(
          B + ((c0 + n) >> 6) * (64 * 64) + kk * 16 * 64, 64 * 64 * 2, 1024);
      if constexpr (STEP == 64) {
        Wgmma<T>::rs_n64(acc, a[kk], db);
      } else {
        Wgmma<T>::rs_n128(acc + n / 2, a[kk], db);
      }
    }
  }
}

// 64-key tiles of a dk / dv CTA (two warpgroups): two at D <= 128, one a
// warpgroup; one at D = 256, each warpgroup with half of the columns
template <int D>
__host__ __device__ constexpr int dkv_key_tiles() {
  return D > 128 ? 1 : 2;
}
// shared memory: the tiles a CTA owns (``own`` 64-row tiles), a two-stage
// ring of two tiles, f32 row statistics, and room to align to 1024 bytes
template <int D>
__host__ __device__ constexpr size_t tc_smem_bytes(int own) {
  return 2 * (own + 4) * size_t(BM) * D + sizeof(float) * 6 * BM + 1024;
}

template <typename T>
__device__ __forceinline__ T* align1024(uint8_t* raw) {
  return reinterpret_cast<T*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
}

// (a) dq and delta
template <typename T, int D>
__global__ void __launch_bounds__(128 * dq_groups<D>())
flash_bwd_dq_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const float* __restrict__ m,
                       const float* __restrict__ l,
                       const T* __restrict__ dout, T* __restrict__ dq,
                       float* __restrict__ delta, int Hq, int Hkv, int Tq,
                       int Tk, float scale, float softcap, int causal,
                       int q_base) {
  constexpr int NTH = 128 * dq_groups<D>();
  constexpr int DV = D / dq_groups<D>();  // dq columns of one warpgroup
  constexpr int CH = D / 8;               // 16-byte chunks a row
  static_assert(tc_smem_bytes<D>(2) <= 232448, "shared memory per block");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  T* sQ = align1024<T>(smem_raw);  // scaled q
  T* sdO = sQ + BM * D;
  T* sK = sdO + BM * D;            // 2 stages
  T* sV = sK + 2 * BM * D;         // 2 stages
  float* sD = reinterpret_cast<float*>(sV + 2 * BM * D);  // delta

  const int tid = threadIdx.x, lane = tid % 32;
  const int r0 = ((tid % 128) / 32) * 16;  // this warp's 16 rows
  const int c0 = (tid / 128) * DV;         // the warpgroup's dq columns
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  // the longest causal rows first: block y runs q block gridDim.y - 1 - y
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t qrow = size_t(bh) * Tq;
  const T* qb = q + qrow * D;
  const T* dob = dout + qrow * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * Tk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Tk * D;
  const int n_q = min(BM, Tq - q0);
  const int kv_end = causal ? min(Tk, q_base + q0 + BM) : Tk;
  const int n_tiles = (kv_end + BM - 1) / BM;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BM;
    T* tk = sK + stage * BM * D;
    T* tv = sV + stage * BM * D;
    for (int i = tid; i < BM * CH; i += NTH) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Tk;
      const size_t src = in ? size_t(k0 + r) * D + c * 8 : 0;
      cp_async16(tk + swz(r, c * 8), kb + src, in ? 16 : 0);
      cp_async16(tv + swz(r, c * 8), vb + src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // q and dO rows (zero past Tq) in the first group, with K/V tile 0
  for (int i = tid; i < BM * CH; i += NTH) {
    const int r = i / CH, c = i % CH;
    const bool in = r < n_q;
    const size_t src = in ? size_t(q0 + r) * D + c * 8 : 0;
    cp_async16(sQ + swz(r, c * 8), qb + src, in ? 16 : 0);
    cp_async16(sdO + swz(r, c * 8), dob + src, in ? 16 : 0);
  }
  load_kv(0, 0);

  // delta = rowsum(dO * O) in f32, NTH / 64 neighbouring threads a row
  {
    constexpr int P = NTH / BM, COLS = D / P;
    const int r = tid / P, part = tid % P;
    float acc = 0.f;
    if (r < n_q) {
      const T* dr = dob + size_t(q0 + r) * D + part * COLS;
      const T* orow = o + (qrow + q0 + r) * D + part * COLS;
#pragma unroll 4
      for (int c = 0; c < COLS; c += 8) {
        uint4 a = *reinterpret_cast<const uint4*>(dr + c);
        uint4 bb = *reinterpret_cast<const uint4*>(orow + c);
        const T* ea = reinterpret_cast<const T*>(&a);
        const T* eb = reinterpret_cast<const T*>(&bb);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc = fmaf(to_f32(ea[j]), to_f32(eb[j]), acc);
      }
    }
#pragma unroll
    for (int off = 1; off < P; off <<= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      sD[r] = acc;
      if (r < n_q) delta[qrow + q0 + r] = acc;
    }
  }
  // this thread's two rows: m log2(e) + log2(max(l, 1e-30)) (+inf past Tq)
  float mb[2], dr[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + r0 + g + 8 * hf;
    mb[hf] = row < Tq ? fmaf(m[qrow + row], kLog2e,
                             __log2f(fmaxf(l[qrow + row], 1e-30f)))
                      : __int_as_float(0x7f800000);
  }

  float acc[DV / 2];  // dq: element e of n-tile j at 4j + e
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

  // one barrier a tile: past it every thread has finished the previous
  // tile, so the next tile's copies may refill the other stage
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    if (tile == 0) {  // the q chunks this thread copied, scaled in T
      const auto s2 = Vec2<T>::splat(scale);
      for (int i = tid; i < BM * CH; i += NTH)
        scale_chunk(sQ + swz(i / CH, (i % CH) * 8), s2);
    }
    fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) load_kv(tile + 1, stage ^ 1);
    if (tile == 0) {
      dr[0] = sD[r0 + g];
      dr[1] = sD[r0 + g + 8];
    }
    const T* tK = sK + stage * BM * D;
    const T* tV = sV + stage * BM * D;
    const int k0 = tile * BM;

    // S = Q K^T and dP = dO V^T, two groups; p from S while dP runs
    float s[32], dp[32];
    wgmma_fence();
    gemm_nt<T, D>(s, sQ, tK);
    wgmma_commit();
    gemm_nt<T, D>(dp, sdO, tV);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<32>(s);
    // p * (1 - tanh^2), 0 where masked
    const bool edge =
        k0 + BM > Tk || (causal && k0 + BM - 1 > q_base + q0 + r0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hf = (i >> 1) & 1;
      float x = s[i], fac = 1.f;
      if (softcap > 0.f) {
        const float th = tanh_ex2(x * inv_cap);
        x = th * softcap;
        fac = 1.f - th * th;
      }
      float p = ex2(fmaf(x, kLog2e, -mb[hf]));
      if (edge) {
        const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
        const int row = q_base + q0 + r0 + g + 8 * hf;
        if (!(col < Tk && (!causal || col <= row))) p = 0.f;
      }
      s[i] = p * fac;
    }
    wgmma_wait<0>();
    reg_fence<32>(dp);
    // ds = p (dp - delta), rounded to T: the register A operand of dq
    uint32_t da[4][4];
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const float d = dr[pr & 1];
      da[pr >> 2][pr & 3] = Pack<T>::pack(s[2 * pr] * (dp[2 * pr] - d),
                                          s[2 * pr + 1] * (dp[2 * pr + 1] - d));
    }
    // dq += dS K over this warpgroup's columns, K read MN-major
    wgmma_fence();
    gemm_rn<T, DV>(acc, da, tK, c0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DV / 2>(acc);
  }

  // dq * D^-0.5 in T, rows past Tq never stored
  T* out = dq + qrow * D;
#pragma unroll
  for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + r0 + g + 8 * hf;
      if (row < Tq)
        *reinterpret_cast<uint32_t*>(out + size_t(row) * D + c0 + 8 * j +
                                     2 * t) =
            Pack<T>::pack(acc[4 * j + 2 * hf] * scale,
                          acc[4 * j + 2 * hf + 1] * scale);
    }
  }
}

// (b) dk and dv
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_dkv_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ m,
                        const float* __restrict__ l,
                        const T* __restrict__ dout,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int Hq, int Hkv, int Tq, int Tk,
                        float scale, float softcap, int causal, int q_base) {
  constexpr int NTH = 256;
  constexpr int KG = dkv_key_tiles<D>(), BK = BM * KG;  // keys a CTA
  constexpr int DV = D / (2 / KG);  // dk / dv columns of a warpgroup
  constexpr int CH = D / 8;
  static_assert(tc_smem_bytes<D>(2 * KG) <= 232448, "shared memory");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  T* sK = align1024<T>(smem_raw);  // KG 64-row tiles
  T* sV = sK + BK * D;
  T* sQ = sV + BK * D;       // 2 stages, scaled q once landed
  T* sdO = sQ + 2 * BM * D;  // 2 stages
  // 2 x 64 of m, then m log2(e) + log2(max(l, 1e-30)) (+inf past Tq)
  float* sM = reinterpret_cast<float*>(sdO + 2 * BM * D);
  float* sL = sM + 2 * BM;   // 2 x 64, l
  float* sDl = sL + 2 * BM;  // 2 x 64, delta

  const int tid = threadIdx.x, lane = tid % 32;
  const int wg = tid / 128;
  const int kg = KG > 1 ? wg : 0;          // the warpgroup's 64-key tile
  const int r0 = kg * BM + ((tid % 128) / 32) * 16;  // this warp's keys
  const int c0 = (KG > 1 ? 0 : wg) * DV;   // the warpgroup's columns
  const T* sKw = sK + kg * BM * D;
  const T* sVw = sV + kg * BM * D;
  const int g = lane / 4, t = lane % 4;
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * BK;
  const size_t krow = size_t(bkv) * Tk;
  const auto s2 = Vec2<T>::splat(scale);  // round(D^-0.5) in T, twice
  // under causality no query before global position k0 sees these keys;
  // with q_base the shard's rows start at global position q_base, and a
  // block no row of the shard sees loops zero times and stores zeros
  const int q_begin = causal ? max(0, k0 - q_base) : 0;
  const int n_qt = q_begin < Tq ? (Tq - q_begin + BM - 1) / BM : 0;
  const int n_tiles = group * n_qt;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // K and V rows (zero past Tk), in the first group
  for (int i = tid; i < BK * CH; i += NTH) {
    const int r = i / CH, c = i % CH;
    const bool in = k0 + r < Tk;
    const size_t src = in ? (krow + k0 + r) * D + c * 8 : 0;
    const int at = (r / BM) * BM * D + swz(r % BM, c * 8);
    cp_async16(sK + at, k + src, in ? 16 : 0);
    cp_async16(sV + at, v + src, in ? 16 : 0);
  }
  auto tile_at = [&](int tile, size_t& qrow, int& qs) {
    qrow = (size_t(b) * Hq + hk * group + tile / n_qt) * Tq;
    qs = q_begin + (tile % n_qt) * BM;
  };
  auto load_q = [&](int tile, int stage) {
    size_t qrow;
    int qs;
    tile_at(tile, qrow, qs);
    T* tq = sQ + stage * BM * D;
    T* tdo = sdO + stage * BM * D;
    for (int i = tid; i < BM * CH; i += NTH) {
      const int r = i / CH, c = i % CH;
      const bool in = qs + r < Tq;
      const size_t src = in ? (qrow + qs + r) * D + c * 8 : 0;
      cp_async16(tq + swz(r, c * 8), q + src, in ? 16 : 0);
      cp_async16(tdo + swz(r, c * 8), dout + src, in ? 16 : 0);
    }
    for (int i = tid; i < BM; i += NTH) {
      const bool in = qs + i < Tq;
      const size_t src = in ? qrow + qs + i : 0;
      cp_async4(sM + stage * BM + i, m + src, in ? 4 : 0);
      cp_async4(sL + stage * BM + i, l + src, in ? 4 : 0);
      cp_async4(sDl + stage * BM + i, delta + src, in ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    load_q(0, 0);
  } else {
    cp_async_commit();
    cp_async_wait<0>();
  }

  float accv[DV / 2], acck[DV / 2];  // dv, dk: element e of n-tile j at 4j+e
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) accv[i] = acck[i] = 0.f;

  // one barrier a tile, as in (a)
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    cp_async_wait<0>();
    size_t qrow;
    int qs;
    tile_at(tile, qrow, qs);
    T* tQ = sQ + stage * BM * D;
    const T* tdO = sdO + stage * BM * D;
    float* tM = sM + stage * BM;
    float* tL = sL + stage * BM;
    const float* tDl = sDl + stage * BM;
    // the chunks this thread copied: q scaled in T, statistics in exp2 form
    for (int i = tid; i < BM * CH; i += NTH)
      scale_chunk(tQ + swz(i / CH, (i % CH) * 8), s2);
    for (int i = tid; i < BM; i += NTH)
      tM[i] = qs + i < Tq
                  ? fmaf(tM[i], kLog2e, __log2f(fmaxf(tL[i], 1e-30f)))
                  : __int_as_float(0x7f800000);
    fence_proxy_async();
    __syncthreads();
    if (tile + 1 < n_tiles) load_q(tile + 1, stage ^ 1);

    // S^T = K Q^T and dP^T = V dO^T, two groups; p from S^T while dP^T runs
    float s[32], dp[32];
    wgmma_fence();
    gemm_nt<T, D>(s, sKw, tQ);
    wgmma_commit();
    gemm_nt<T, D>(dp, sVw, tdO);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence<32>(s);
    // P^T rounded to T (the A operand of dv), p * (1 - tanh^2) kept in s;
    // element e of n-tile j: key g + 8 (e >> 1), query 8j + 2t + (e & 1)
    const bool edge = causal && k0 + r0 + 15 > q_base + qs;
    uint32_t pa[4][4];
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int col = 8 * (pr >> 1) + 2 * t;
      const float2 mo = *reinterpret_cast<const float2*>(tM + col);
      float p2[2], f2[2] = {1.f, 1.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[2 * pr + e];
        if (softcap > 0.f) {
          const float th = tanh_ex2(x * inv_cap);
          x = th * softcap;
          f2[e] = 1.f - th * th;
        }
        p2[e] = ex2(fmaf(x, kLog2e, -(e ? mo.y : mo.x)));
        if (edge && k0 + r0 + g + 8 * (pr & 1) > q_base + qs + col + e)
          p2[e] = 0.f;
      }
      pa[pr >> 2][pr & 3] = Pack<T>::pack(p2[0], p2[1]);
      s[2 * pr] = p2[0] * f2[0];
      s[2 * pr + 1] = p2[1] * f2[1];
    }
    // dv += P^T dO over this warpgroup's columns, dO read MN-major
    wgmma_fence();
    gemm_rn<T, DV>(accv, pa, tdO, c0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<32>(dp);
    // dS^T = p (dp - delta), rounded to T: the A operand of dk
    uint32_t da[4][4];
#pragma unroll
    for (int pr = 0; pr < 16; ++pr) {
      const int col = 8 * (pr >> 1) + 2 * t;
      const float2 dd = *reinterpret_cast<const float2*>(tDl + col);
      da[pr >> 2][pr & 3] =
          Pack<T>::pack(s[2 * pr] * (dp[2 * pr] - dd.x),
                        s[2 * pr + 1] * (dp[2 * pr + 1] - dd.y));
    }
    // dk += dS^T q_scaled over this warpgroup's columns, q read MN-major
    wgmma_fence();
    gemm_rn<T, DV>(acck, da, tQ, c0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence<DV / 2>(accv);
    reg_fence<DV / 2>(acck);
  }

  // dk, dv in T, keys past Tk never stored
  const auto store = [&](T* outp, const float* a) {
#pragma unroll
    for (int j = 0; j < DV / 8; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int key = k0 + r0 + g + 8 * hf;
        if (key < Tk)
          *reinterpret_cast<uint32_t*>(outp + (krow + key) * D + c0 +
                                       8 * j + 2 * t) =
              Pack<T>::pack(a[4 * j + 2 * hf], a[4 * j + 2 * hf + 1]);
      }
    }
  };
  store(dv, accv);
  store(dk, acck);
}

// --------------------------------------------------------------------------
// float32: the scalar path
// --------------------------------------------------------------------------

// output-column groups of four warps: D = 256 splits its columns in two
template <int D>
__host__ __device__ constexpr int groups() {
  return D > 128 ? 2 : 1;
}
constexpr int PAD = 4;  // row padding: 8 rows of 32-bit loads hit 32 banks
constexpr int BN = 32;  // the tile each CTA loops over: keys (a), queries (b)

// shared memory of a CTA: its own 64 rows of two operands, the loop's tile
// of two, each warp's 16 staging rows, three f32 statistics a row
template <int D, int OWN_STATS>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(2 * BM + 2 * BN) * (D + PAD) +
                          size_t(4 * groups<D>()) * 16 * (BN + PAD) +
                          3 * (OWN_STATS ? BM : BN));
}

// c (16 x 8 * NT8, f32, the mma C fragment layout: element e of n-tile j
// at c[4j + e] is row g + 8 * (e >> 1), column 8j + 2t + (e & 1), g = lane
// / 4, t = lane % 4) += A . B over KD, A row-major (16 rows of stride lda,
// k contiguous); B's (k, n) at B[n * ldb + k] when KMAJOR, else B[k * ldb
// + n]
template <int NT8, int KD, bool KMAJOR>
__device__ __forceinline__ void warp_fma(float* c, const float* A, int lda,
                                         const float* B, int ldb, int lane) {
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

// rows [r0, r0 + n) of a (T_rows, D) matrix into a padded tile (stride
// D + PAD), rows past n_valid zero, times ``mul``
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int n_valid, float mul,
                                          int tid, int nth) {
  constexpr int LD = D + PAD;
  for (int i = tid; i < rows * (D / 4); i += nth) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid)
      x = *reinterpret_cast<const float4*>(src + size_t(r) * D + c);
    x.x *= mul;
    x.y *= mul;
    x.z *= mul;
    x.w *= mul;
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

// a warp's C fragments (16 x 8 * NT8) into its staging rows
template <int NT8>
__device__ __forceinline__ void stage(float* stg, int ls, const float* x,
                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stg[(g + 8 * (e >> 1)) * ls + 8 * j + 2 * t + (e & 1)] = x[4 * j + e];
  }
}

// a warp's accumulator fragments (16 rows from ``row0`` of a (n_rows, D)
// output, columns c0 + 8j + 2t + {0, 1}) times ``mul``
template <int NT8, int D>
__device__ __forceinline__ void store_rows(float* out, const float* acc,
                                           int row0, int n_rows, int c0,
                                           float mul, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row0 + g + 8 * hf;
      if (row < n_rows) {
        float* p = out + size_t(row) * D + c0 + 8 * j + 2 * t;
        p[0] = acc[4 * j + 2 * hf] * mul;
        p[1] = acc[4 * j + 2 * hf + 1] * mul;
      }
    }
  }
}

// (a) dq and delta
template <int D>
__global__ void __launch_bounds__(128 * groups<D>())
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int Hq, int Hkv, int Tq, int Tk, float scale,
                        float softcap, int causal, int q_base) {
  constexpr int NW = 4 * groups<D>(), NTH = 32 * NW;
  constexpr int DV = D / groups<D>();
  constexpr int LD = D + PAD, LS = BN + PAD;
  constexpr int NS = BN / 8, NO = DV / 8;
  static_assert(smem_bytes<D, 1>() <= 232448, "shared memory");
  extern __shared__ float smem_f32[];
  float* sQ = smem_f32;                             // BM x LD, scaled q
  float* sdO = sQ + BM * LD;                        // BM x LD
  float* sK = sdO + BM * LD;                        // BN x LD
  float* sV = sK + BN * LD;                         // BN x LD
  float* sS = sV + BN * LD;                         // NW x 16 x LS, ds
  float* sM = sS + NW * 16 * LS;
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
  const float* kb = k + (size_t(b) * Hkv + hk) * Tk * D;
  const float* vb = v + (size_t(b) * Hkv + hk) * Tk * D;
  const int n_q = min(BM, Tq - q0);

  load_rows<D>(sQ, q + (qrow + q0) * D, BM, n_q, scale, tid, NTH);
  load_rows<D>(sdO, dout + (qrow + q0) * D, BM, n_q, 1.f, tid, NTH);
  // delta = rowsum(dO * O) in f32, one warp a row; the statistics beside it
  for (int r = warp; r < BM; r += NW) {
    float acc = 0.f;
    if (r < n_q) {
      const float* dr = dout + (qrow + q0 + r) * D;
      const float* orow = o + (qrow + q0 + r) * D;
      for (int c = lane; c < D; c += 32) acc = fmaf(dr[c], orow[c], acc);
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
  float* stg = sS + warp * 16 * LS;
  float acc[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) acc[i] = 0.f;

  const int kv_end = causal ? min(Tk, q_base + q0 + BM) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    load_rows<D>(sK, kb + size_t(k0) * D, BN, Tk - k0, 1.f, tid, NTH);
    load_rows<D>(sV, vb + size_t(k0) * D, BN, Tk - k0, 1.f, tid, NTH);
    __syncthreads();

    // S = Q K^T, then p * (1 - tanh^2) (0 where masked)
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    warp_fma<NS, D, true>(s, sQ + r0 * LD, LD, sK, LD, lane);
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
    // dP = dO V^T; ds = p (dp - delta), staged
    float dp[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) dp[i] = 0.f;
    warp_fma<NS, D, true>(dp, sdO + r0 * LD, LD, sV, LD, lane);
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) dp[i] = s[i] * (dp[i] - dr[(i & 3) >> 1]);
    stage<NS>(stg, LS, dp, lane);
    __syncwarp();
    // dq += ds K over this warp group's columns
    warp_fma<NO, BN, false>(acc, stg, LS, sK + c0, LD, lane);
  }
  store_rows<NO, D>(dq + qrow * D, acc, q0 + r0, Tq, c0, scale, lane);
}

// (b) dk and dv
template <int D>
__global__ void __launch_bounds__(128 * groups<D>())
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ dout,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Hq, int Hkv, int Tq, int Tk, float scale,
                         float softcap, int causal, int q_base) {
  constexpr int NW = 4 * groups<D>(), NTH = 32 * NW;
  constexpr int DV = D / groups<D>();
  constexpr int LD = D + PAD, LS = BN + PAD;
  constexpr int NS = BN / 8, NO = DV / 8;
  static_assert(smem_bytes<D, 0>() <= 232448, "shared memory");
  static_assert(BM % BN == 0, "query tiles align with key blocks");
  extern __shared__ float smem_f32[];
  float* sK = smem_f32;                             // BM x LD
  float* sV = sK + BM * LD;                         // BM x LD
  float* sQ = sV + BM * LD;                         // BN x LD, scaled q
  float* sdO = sQ + BN * LD;                        // BN x LD
  float* sS = sdO + BN * LD;                        // NW x 16 x LS, p, ds
  float* sM = sS + NW * 16 * LS;
  float* sL = sM + BN;
  float* sD = sL + BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * DV;
  const int g = lane >> 2, t = lane & 3;
  const int bkv = blockIdx.x, b = bkv / Hkv, hk = bkv % Hkv;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.y * BM;
  const size_t krow = size_t(bkv) * Tk;

  load_rows<D>(sK, k + (krow + k0) * D, BM, Tk - k0, 1.f, tid, NTH);
  load_rows<D>(sV, v + (krow + k0) * D, BM, Tk - k0, 1.f, tid, NTH);
  float* stg = sS + warp * 16 * LS;
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
      load_rows<D>(sQ, q + (qrow + qs) * D, BN, Tq - qs, scale, tid, NTH);
      load_rows<D>(sdO, dout + (qrow + qs) * D, BN, Tq - qs, 1.f, tid, NTH);
      for (int i = tid; i < BN; i += NTH) {
        const bool in = qs + i < Tq;
        sM[i] = in ? m[qrow + qs + i] : 0.f;
        sL[i] = in ? fmaxf(l[qrow + qs + i], 1e-30f) : 1.f;
        sD[i] = in ? delta[qrow + qs + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T; p staged, p * (1 - tanh^2) kept (0 where masked)
      float st[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) st[i] = 0.f;
      warp_fma<NS, D, true>(st, sK + r0 * LD, LD, sQ, LD, lane);
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
      stage<NS>(stg, LS, p, lane);
      __syncwarp();
      // dv += p^T dO
      warp_fma<NO, BN, false>(acc_v, stg, LS, sdO + c0, LD, lane);
      __syncwarp();  // the staging rows are rewritten below
      // dP^T = V dO^T; ds^T = p (dp - delta), staged
      float dpt[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) dpt[i] = 0.f;
      warp_fma<NS, D, true>(dpt, sV + r0 * LD, LD, sdO, LD, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t + (e & 1);
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - sD[ql]);
        }
      }
      stage<NS>(stg, LS, dpt, lane);
      __syncwarp();
      // dk += ds^T q_scaled
      warp_fma<NO, BN, false>(acc_k, stg, LS, sQ + c0, LD, lane);
    }
  }
  store_rows<NO, D>(dk + krow * D, acc_k, k0 + r0, Tk, c0, 1.f, lane);
  store_rows<NO, D>(dv + krow * D, acc_v, k0 + r0, Tk, c0, 1.f, lane);
}

// --------------------------------------------------------------------------
// launch
// --------------------------------------------------------------------------

// the two kernels of one instance, their threads and shared memory
template <typename T, int D>
struct Instance {
  static constexpr bool TC = !std::is_same<T, float>::value;
  static constexpr int threads_a = 128 * (TC ? dq_groups<D>() : groups<D>());
  static constexpr int threads_b = TC ? 256 : 128 * groups<D>();
  static constexpr int keys_b = TC ? BM * dkv_key_tiles<D>() : BM;
  static size_t smem_a() {
    if constexpr (TC) return tc_smem_bytes<D>(2);
    else return smem_bytes<D, 1>();
  }
  static size_t smem_b() {
    if constexpr (TC) return tc_smem_bytes<D>(2 * dkv_key_tiles<D>());
    else return smem_bytes<D, 0>();
  }
  static auto kernel_a() {
    if constexpr (TC) return flash_bwd_dq_tc_kernel<T, D>;
    else return flash_bwd_dq_f32_kernel<D>;
  }
  static auto kernel_b() {
    if constexpr (TC) return flash_bwd_dkv_tc_kernel<T, D>;
    else return flash_bwd_dkv_f32_kernel<D>;
  }
};

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* m, const float* l, const void* dout, void* dq,
           void* dk, void* dv, float* delta, int B, int Hq, int Hkv, int Tq,
           int Tk, float scale, float softcap, int causal, int q_base,
           cudaStream_t stream) {
  using I = Instance<T, D>;
  const auto ka = I::kernel_a();
  const auto kb = I::kernel_b();
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, int(I::smem_a()));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(I::smem_b()));
  if (err != cudaSuccess) return int(err);
  ka<<<dim3(B * Hq, (Tq + BM - 1) / BM), I::threads_a, I::smem_a(),
       stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, m, l,
      (const T*)dout, (T*)dq, delta, Hq, Hkv, Tq, Tk, scale, softcap, causal,
      q_base);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  kb<<<dim3(B * Hkv, (Tk + I::keys_b - 1) / I::keys_b), I::threads_b,
       I::smem_b(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, m, l, (const T*)dout, delta,
      (T*)dk, (T*)dv, Hq, Hkv, Tq, Tk, scale, softcap, causal, q_base);
  return int(cudaGetLastError());
}

// registers a thread and local (spill) bytes of both kernels
template <typename T, int D>
int attrs(int* out) {
  using I = Instance<T, D>;
  cudaFuncAttributes a, b;
  cudaError_t err = cudaFuncGetAttributes(&a, I::kernel_a());
  if (err != cudaSuccess) return int(err);
  err = cudaFuncGetAttributes(&b, I::kernel_b());
  if (err != cudaSuccess) return int(err);
  out[0] = a.numRegs;
  out[1] = int(a.localSizeBytes);
  out[2] = b.numRegs;
  out[3] = int(b.localSizeBytes);
  return 0;
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

template <typename T>
int attrs_d(int D, int* out) {
  switch (D) {
    case 64:
      return attrs<T, 64>(out);
    case 128:
      return attrs<T, 128>(out);
    case 256:
      return attrs<T, 256>(out);
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

// out[4]: registers a thread and local (spill) bytes a thread of the dq
// kernel, then of the dk / dv kernel, of the instance (D, dtype)
extern "C" int flash_bwd_attrs(int D, int dtype, int* out) {
  switch (dtype) {
    case 0:
      return attrs_d<float>(D, out);
    case 1:
      return attrs_d<__nv_bfloat16>(D, out);
    case 2:
      return attrs_d<__half>(D, out);
    default:
      return int(cudaErrorInvalidValue);
  }
}
