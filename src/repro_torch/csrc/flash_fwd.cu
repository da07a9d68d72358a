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
// One CTA per (b*Hq + h, 64-row q block); GQA head h reads kv head
// h / (Hq/Hkv).  The CTA loops over 64-key K/V tiles and, under causality,
// stops at the last key its rows can see; the ragged edges of any Tq/Tk
// are masked here (rows past Tq are zero and never stored, keys past Tk
// are zero-filled and masked), so callers pass any length.  Bound on the
// H100: operations (4*D flops per visible (q, k) pair).
//
// bf16 / fp16 (the serve path) run on the tensor cores with Hopper's
// warpgroup MMA (wgmma): a CTA of one warpgroup owns 64 query rows.
// S = Q.K^T is a wgmma m64n64k16 chain with Q and K read from shared
// memory through descriptors (128-byte swizzle, K-major), accumulating in
// f32 registers; the online softmax runs on
// those registers, and P, rounded to the input dtype, is fed from them as
// the register A operand of O += P.V (m64n{D}k16, V read MN-major from
// shared memory) -- exactly the rounding points above; only the summation
// order differs from the plain version.  K/V tiles arrive by 16-byte
// cp.async (zero-filled past Tk) into a two-stage ring, so the next tile
// loads while this one multiplies, and are stored in the swizzled layout
// the descriptors name.
//
// f32 keeps the scalar path (f32 FMAs out of shared memory): it is not on
// the serve path, and the card-vs-CPU agreement of the small f32 model
// (1e-5) needs full f32 products, which TF32 tensor cores would break.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

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


// --------------------------------------------------------------------------
// bf16 / fp16: tensor cores (mma.sync.m16n8k16, ldmatrix, cp.async ring)
// --------------------------------------------------------------------------

// one warpgroup a CTA: two, sharing each K/V tile, ran 10-35 % slower on
// the H100 (at ~200 registers a thread only one such CTA fits an SM)
constexpr int TC_NT = 128;
constexpr float kLog2e = 1.4426950408889634f;

// two f32 -> one register of two T, the lower column in the low half
template <typename T>
struct Pack;
template <>
struct Pack<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Pack<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

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

// element offset of (row, col) in a 64-row tile of D 16-bit columns, in
// blocks of 64 columns (8 KB each, 128-byte rows), each row's eight 16-byte
// chunks XOR-swizzled by row % 8: the 128-byte swizzle of wgmma's shared
// operands (for a 1024-byte aligned tile), free of bank conflicts for
// ldmatrix too
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  return (col >> 6) * (64 * 64) + row * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// warpgroup MMA (wgmma): D (64 x N, f32 registers) = A . B with A from
// shared memory (ss: Q, K-major) or from registers (rs: P), B from shared
// memory through a descriptor (K, K-major; V, MN-major, so trans-b = 1)
template <typename T>
struct Wgmma;
template <>
struct Wgmma<__nv_bfloat16> {
  static __device__ __forceinline__ void ss_n64(float* d, uint64_t da,
                                                uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs_n64(float* d, const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  static __device__ __forceinline__ void rs_n128(float* d, const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};
template <>
struct Wgmma<__half> {
  static __device__ __forceinline__ void ss_n64(float* d, uint64_t da,
                                                uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs_n64(float* d, const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  static __device__ __forceinline__ void rs_n128(float* d, const uint32_t* a,
                                                 uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// writes of the generic proxy (st.shared, cp.async) made visible to the
// async proxy that wgmma reads shared memory through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo,
                                              int sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}


template <int D>
constexpr size_t tc_smem_bytes() {
  // Q, 2 x (K, V), and room to align the tiles to 1024 bytes
  return 2 * (size_t(BQ) * D + 4 * size_t(BK) * D) + 1024;
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_NT)
flash_fwd_tc_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int Hq,
                    int Hkv, int Tq, int Tk, float scale, float softcap,
                    int causal) {
  constexpr int CH = D / 8;   // 16-byte chunks a row
  constexpr int KS = D / 16;  // k-steps of Q.K^T
  constexpr int NS = BK / 8;  // n-tiles of S
  constexpr int ND = D / 8;   // n-tiles of O
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw +
                               ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  T* sK = sQ + BQ * D;        // 2 stages
  T* sV = sK + 2 * BK * D;    // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  // the longest causal rows first: block y runs q block gridDim.y - 1 - y
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const T* qb = q + (size_t(b) * Hq + h) * Tq * D;
  const T* kb = k + (size_t(b) * Hkv + hk) * Tk * D;
  const T* vb = v + (size_t(b) * Hkv + hk) * Tk * D;
  T* ob = o + (size_t(b) * Hq + h) * Tq * D;

  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;

  auto load_kv = [&](int tile, int stage) {
    const int k0 = tile * BK;
    T* dk = sK + stage * BK * D;
    T* dv = sV + stage * BK * D;
    for (int i = tid; i < BK * CH; i += TC_NT) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < Tk;
      const size_t src = in ? size_t(k0 + r) * D + c * 8 : 0;
      cp_async16(dk + swz<D>(r, c * 8), kb + src, in ? 16 : 0);
      cp_async16(dv + swz<D>(r, c * 8), vb + src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0, 0);

  // the scaled Q tile, rounded to T, rows past Tq zero
  const float scale_t = Elem<T>::round(scale);
  for (int i = tid; i < BQ * CH; i += TC_NT) {
    const int r = i / CH, c = i % CH;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (q0 + r < Tq)
      raw = *reinterpret_cast<const uint4*>(qb + size_t(q0 + r) * D + c * 8);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = Elem<T>::store(Elem<T>::load(e[j]) * scale_t);
    *reinterpret_cast<uint4*>(sQ + swz<D>(r, c * 8)) = raw;
  }
  fence_proxy_async();
  __syncthreads();

  const int r0 = warp * 16;  // this warp's 16 rows of the 64

  float acc[ND * 4];  // element e of n-tile j at 4j + e
#pragma unroll
  for (int j = 0; j < ND * 4; ++j) acc[j] = 0.f;
  float m_run[2] = {NEG, NEG}, l_run[2] = {0.f, 0.f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_kv(tile + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const T* tK = sK + stage * BK * D;
    const T* tV = sV + stage * BK * D;
    const int k0 = tile * BK;
    // S = Q K^T, f32 accumulators: s[4j + e] covers keys 8j..8j+7
    float s[NS * 4];
#pragma unroll
    for (int j = 0; j < NS * 4; ++j) s[j] = 0.f;
    // k-step ks reads columns 16ks..16ks+15: block ks / 4, 32 bytes a step
    // within its 128-byte rows; 8-row groups 1024 bytes apart
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int off = (ks >> 2) * (64 * 64) + (ks & 3) * 16;
      Wgmma<T>::ss_n64(s, gmma_desc(sQ + off, 16, 1024),
                       gmma_desc(tK + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait0();

    // softcap and mask; element e of s[j] is row g + 8 * (e >> 1), key
    // 8j + 2t + (e & 1)
    const bool edge = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + r0);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (edge) {
          const int kv_pos = k0 + 8 * j + 2 * t + (e & 1);
          const int q_pos = q0 + r0 + g + 8 * (e >> 1);
          if (!(kv_pos < Tk && (!causal || kv_pos <= q_pos))) x = NEG;
        }
        s[4 * j + e] = x;
      }
    }

    // online softmax on the accumulators: rows g (half 0) and g + 8 (1)
    float corr[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hf], s[4 * j + 2 * hf + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hf], mx);
      const float mb = m_new * kLog2e;
      corr[hf] = exp2f(m_run[hf] * kLog2e - mb);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
          const float p = exp2f(fmaf(s[4 * j + e], kLog2e, -mb));
          sum += p;
          s[4 * j + e] = p;
        }
      }
      l_run[hf] = l_run[hf] * corr[hf] + sum;  // this thread's columns
      m_run[hf] = m_new;
    }
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[4 * j + 0] *= corr[0];
      acc[4 * j + 1] *= corr[0];
      acc[4 * j + 2] *= corr[1];
      acc[4 * j + 3] *= corr[1];
    }

    // O += P V: P rounded to T, straight from the S registers as A
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = Pack<T>::pack(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = Pack<T>::pack(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = Pack<T>::pack(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = Pack<T>::pack(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // keys 16kk..16kk+15: two 8-row groups (1024 bytes apart) of every
    // 64-column block (8 KB apart), read MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = gmma_desc(tV + kk * 16 * 64, 64 * 64 * 2, 1024);
      if constexpr (D == 64) {
        Wgmma<T>::rs_n64(acc, pa[kk], dv);
      } else {
        Wgmma<T>::rs_n128(acc, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    __syncthreads();  // this stage's readers are done before it refills
  }

  // o = acc / max(l, 1e-30) in T, through this warp's rows of the Q tile
  // (read only before the loop) for 16-byte stores
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float l = l_run[hf];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[hf] = fmaxf(l, 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t w = Pack<T>::pack(acc[4 * j + 2 * hf] / l_run[hf],
                                      acc[4 * j + 2 * hf + 1] / l_run[hf]);
      *reinterpret_cast<uint32_t*>(
          sQ + swz<D>(r0 + g + 8 * hf, 8 * j + 2 * t)) = w;
    }
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i % CH;
    if (q0 + r0 + r < Tq)
      *reinterpret_cast<uint4*>(ob + size_t(q0 + r0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(sQ + swz<D>(r0 + r, c * 8));
  }
}

// --------------------------------------------------------------------------
// float32: the scalar path
// --------------------------------------------------------------------------

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
  const auto go = [&](auto kernel, size_t smem, int threads, int rows) {
    const dim3 grid(B * Hq, (Tq + rows - 1) / rows);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, threads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Tq, Tk,
        scale, softcap, causal);
    return int(cudaGetLastError());
  };
  if constexpr (std::is_same<T, float>::value) {
    return go(flash_fwd_kernel<T, D>, smem_bytes<D>(), NT, BQ);
  } else {
    return go(flash_fwd_tc_kernel<T, D>, tc_smem_bytes<D>(), TC_NT, BQ);
  }
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
