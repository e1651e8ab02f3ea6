// Hopper (sm_90a) building blocks shared by the flash-attention kernels:
// mbarriers, TMA tile loads and their tensor maps, wgmma shared-memory
// descriptors, and the bf16 wgmma products with fp32 accumulators.
//
// Tiles. Every bf16 operand tile is [rows][D] with D contiguous, loaded by
// TMA with the swizzle whose span is one row: 128 bytes for D = 64, 64
// bytes for D = 32. A row of D = 128 (256 bytes) is twice what a swizzle
// spans, so such a tile is two sub-tiles of [64][64], the columns 0-63
// and then 64-127, each its own TMA box (SUB below is a sub-tile's
// width, D for D <= 64). So a (sub-)tile is 8-row groups of 8 * 2 SUB
// bytes, the canonical wgmma layout for that swizzle, and the same tile
// serves two ways:
//   - K-major (the reduction runs along D): Q or K in S = Q K^T, dO or V in
//     dP = dO V^T. Descriptor: stride between 8-row groups 8 * 2 SUB bytes;
//     a 16-wide k step advances the start address by 32 bytes, and at
//     D = 128 the fifth to eighth k steps run on the second sub-tile.
//   - MN-major (the reduction runs along the rows, N = D contiguous): V in
//     O += P V, dO and Q in dV += P^T dO and dK += dS^T Q, K in dQ += dS K.
//     The transpose bit of B is set; the 8-row groups are the k groups,
//     and a 16-wide k step advances the start address by 16 rows. At
//     D = 128 each sub-tile is the B of its own m64n64 product, into
//     the accumulator's columns 0-63 and 64-127.
// Tiles and sub-tiles start on a multiple of 1024 bytes, so the swizzle
// phase of every row is its row index mod 8 and the descriptors' base
// offset is 0. A tile with two sub-tiles always has 64 rows.
//
// Fragments (per thread t of a 128-thread warpgroup, warp w = t / 32,
// lane l, g = l / 4, c = l % 4): the fp32 accumulator of an m64nN product
// holds d[4n + 2i + j] = C[16w + g + 8i][8n + 2c + j] (at N = 128 the two
// m64n64 halves side by side keep that layout); the bf16 A operand
// of an m64n*k16 product taken from registers holds four 32-bit words
// {A[16w+g][2c..], A[16w+g+8][2c..], A[16w+g][2c+8..], A[16w+g+8][2c+8..]}.
// So the accumulator of S packs pairwise into the A operand of the next
// product with no data movement (pack_a below).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// columns of a sub-tile: one swizzle span of at most 64 bf16
__host__ __device__ constexpr int sub_cols(int d) { return d > 64 ? 64 : d; }

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the TMA unit
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the barrier has completed the phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0 innermost .. c3) of `map` into
// shared memory at `dst`, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// The [rows][D] box at time step `row` of head h, batch b, as D / SUB
// sub-tiles of [rows][SUB] one after the other at `dst`, completing on
// `bar` (rows is 64 whenever there are two sub-tiles)
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int h, int row, int b, int rows) {
  constexpr int SUB = sub_cols(D);
#pragma unroll
  for (int part = 0; part < D / SUB; ++part)
    tma_load_4d(static_cast<uint8_t*>(dst) + part * rows * SUB * 2, map, bar, part * SUB, h,
                row, b);
}

// Shared-memory matrix descriptor of a swizzled [rows][SUB] bf16 (sub-)tile
// whose rows are ROW_BYTES = 2 SUB long (128 -> 128-byte swizzle, 64 ->
// 64-byte).
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t tile_desc(const void* tile) {
  static_assert(ROW_BYTES == 128 || ROW_BYTES == 64, "rows of 64 or 32 bf16");
  constexpr uint64_t layout = ROW_BYTES == 128 ? 1 : 2;  // SWIZZLE_128B : SWIZZLE_64B
  constexpr uint64_t sbo = 8 * ROW_BYTES;                // next 8-row group
  return uint64_t((smem_u32(tile) & 0x3FFFF) >> 4) | (uint64_t(16 >> 4) << 16) |
         (uint64_t(sbo >> 4) << 32) | (layout << 62);
}

// descriptor steps (in the descriptor's 16-byte units) for the kk-th
// 16-wide k slice of a tile
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  return uint64_t(kk * 32 >> 4);
}
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t mnmajor_step(int kk) {
  return uint64_t(kk * 16 * ROW_BYTES >> 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of products are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x in one MUFU instruction (results below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operands of the four 16-wide k slices of an m64n64 fp32
// accumulator laid out as above (its columns are the k index), rounded to
// bf16: slice kk is a[4kk .. 4kk + 3]. Packed before the products are
// issued, so no register an in-flight wgmma reads is written meanwhile.
__device__ __forceinline__ void pack_a(const float (&s)[32], uint32_t (&a)[16]) {
#pragma unroll
  for (int r = 0; r < 16; ++r) a[r] = pack_bf16(s[2 * r], s[2 * r + 1]);
}

#define HT_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HT_F16(i) HT_F4(i), HT_F4(i + 4), HT_F4(i + 8), HT_F4(i + 12)

// d (+)= A B, m64n64k16, bf16 in, fp32 out, A and B from shared memory,
// both K-major. scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HT_F16(0), HT_F16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64nDk16 with A from registers and B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HT_F16(0), HT_F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : HT_F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HT_F16
#undef HT_F4

// S = A B^T over a [64][D] A tile and a [64][D] B tile in shared memory,
// both K-major: D / 16 products of m64n64k16, the first overwriting S.
template <int D>
__device__ __forceinline__ void gemm_nt(float (&s)[32], const void* a_tile,
                                        const void* b_tile) {
  constexpr int SUB = sub_cols(D), SUB_BYTES = 64 * SUB * 2;
  const uint8_t* a = static_cast<const uint8_t*>(a_tile);
  const uint8_t* b = static_cast<const uint8_t*>(b_tile);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int part = kk / (SUB / 16), k = kk % (SUB / 16);
    const uint64_t da = tile_desc<2 * SUB>(a + part * SUB_BYTES);
    const uint64_t db = tile_desc<2 * SUB>(b + part * SUB_BYTES);
    wgmma_ss_n64(s, da + kmajor_step(k), db + kmajor_step(k), kk > 0 ? 1 : 0);
  }
}

// acc += P B over 64 k rows: P packed by pack_a, B a [64][D] tile in
// shared memory, MN-major; one m64n{SUB}k16 chain per sub-tile, into the
// accumulator's matching columns.
template <int D>
__device__ __forceinline__ void gemm_pv(float (&acc)[D / 2], const uint32_t (&p)[16],
                                        const void* b_tile) {
  constexpr int SUB = sub_cols(D), SUB_BYTES = 64 * SUB * 2;
#pragma unroll
  for (int part = 0; part < D / SUB; ++part) {
    float(&cols)[SUB / 2] = *reinterpret_cast<float(*)[SUB / 2]>(&acc[part * (SUB / 2)]);
    const uint64_t db = tile_desc<2 * SUB>(static_cast<const uint8_t*>(b_tile) + part * SUB_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs(cols, p + 4 * kk, db + mnmajor_step<2 * SUB>(kk));
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime, so the
// library links nothing but the runtime
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// Tensor map of a bf16 [B,T,H,D] operand read through its element strides
// (D contiguous), with a box of `rows` time steps of one head and SUB
// columns: the box lands in shared memory as a swizzled [rows][SUB]
// (sub-)tile (tma_load_tile issues one box per sub-tile). Rows past T
// come in as zeros. Base and strides must be multiples of 16 bytes; the
// wrapper checks that and cuTensorMapEncodeTiled refuses anything else.
inline cudaError_t encode_bthd(CUtensorMap* map, const void* base, int B, int T, int H, int D,
                               int64_t sb, int64_t st, int64_t sh, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (B == 1) sb = st * T;  // a stride of a size-1 dimension is never used
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(H), cuuint64_t(T), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(st) * 2, cuuint64_t(sb) * 2};
  const int sub = sub_cols(D);
  const cuuint32_t box[4] = {cuuint32_t(sub), 1, cuuint32_t(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        sub == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
