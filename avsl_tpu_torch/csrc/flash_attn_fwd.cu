// Flash-attention forward for Hopper (sm_90a), CUDA C++, plain C entry.
//
// Replaces the TPU kernel `_attn_kernel` launched by `_flash_fwd_pallas`
// in avsl_tpu/kernels/attention.py (entered through `fused_attention`):
//   O = softmax(Q K^T / sqrt(D) + mask) V
// with fp32 scores and softmax, an optional causal mask (k <= q, top-left,
// q the absolute row) and an optional per-batch key-length mask. Masked
// logits take the finite value -1e30, so a row whose key length is 0 gets
// uniform weights over all Tk keys and a finite output, as in the
// reference. Keys past Tk in the ragged last tile take -inf (weight 0).
//
// What bounds it: at the serving shape (B=8, H=20, T=1500, D=64, bf16) the
// work is 4*B*H*T^2*D = 9.2e10 FLOP against 123 MB of Q, K, V and O, about
// 750 FLOP a byte, far above the H100's ~295 FLOP/byte ridge: the kernel
// is bound by arithmetic, and only the tensor cores (989 TFLOP/s bf16,
// against 67 TFLOP/s on the fp32 FMA pipes) come near the bound. The
// [Tq, Tk] score matrix never leaves the chip: one pass over K/V per q
// tile, online softmax in registers, one division by the row sum at the
// end, so device memory traffic stays near the 123 MB floor.
//
// bf16 design (the main paths' type), D in {16, 32, 64, 128}:
//   - one consumer warpgroup (128 threads) per 64 q rows; a block holds 2
//     warpgroups (128 rows) when the 128-row grid still has a block for
//     every SM, else 1 (the training shapes at B = 1: 1,20,500,500 gives
//     160 blocks of 64 rows against 80 of 128); always 1 at D = 128, where
//     one warpgroup's O accumulator alone is 64 fp32 registers a thread
//     and the Q, K and V tiles are twice as large;
//   - S = Q K^T on wgmma m64n64k16, A = the Q tile and B = the K tile in
//     shared memory, both K-major (D contiguous);
//   - O += P V on wgmma m64nDk16 with A = P from registers: the fp32
//     accumulator of S, after the online softmax, packs pairwise to bf16
//     in exactly the A-fragment layout; B = the V tile [keys][D], MN-major
//     (transpose bit set). At D = 128 a 256-byte row is twice a swizzle
//     span, so every tile is two [64][64] sub-tiles (two TMA boxes): S
//     takes 8 k steps over both, and O is two m64n64 chains, one per V
//     sub-tile (csrc/hopper_tiles.cuh);
//   - Q, K and V tiles come by TMA (4-D tensor maps over the [B,T,H,D]
//     strides, encoded in the C entry; swizzle of one 2D-byte row) into a
//     ring of STAGES K/V stages that complete on mbarriers. Thread 0
//     issues the loads: the first STAGES tiles up front, then tile
//     j + STAGES once every warpgroup is done with tile j (one
//     __syncthreads a tile), so STAGES - 1 tiles are in flight while one
//     is computed. A separate producer warp with "empty" mbarriers, so
//     that the warpgroups never wait for each other, measured slower on
//     an H100 (0.32 against 0.22 ms at the serving shape, one run), and the
//     softmax of tile j overlapped with the PV product of tile j - 1
//     inside a warpgroup measured no faster: the SM's issue slots and
//     exponential units, not latency, bound this loop;
//   - online softmax in fp32 on the S fragment, in log2 units (the scale
//     folds in log2(e), exp2), rescaling the O accumulator; P is rounded
//     to bf16 only as the operand of PV, unnormalised, and the row sum l
//     is summed from the fp32 exponentials. At D = 64 the exponentials
//     (one MUFU op a score, 16 a clock on an SM) take as long as the two
//     products of a tile on the tensor cores, so the softmax is kept to
//     about five instructions a score (the scale folds into one FFMA
//     before a single ex2.approx) and overlaps the products of the other
//     warpgroups on the SM;
//   - key tiles wholly past the key length, or wholly after the block's
//     last q row under the causal mask, contribute exactly 0 and are not
//     visited, except for a row of key length 0, which weighs every key;
//     keys past Tk come in as TMA's zero fill and are masked to -inf.
// fp32 operands cannot go through the bf16 tensor cores without changing
// the result (and TF32 would miss the fp32 tolerance), so the fp32
// instantiation keeps the first version's body on the FMA pipes: one
// 256-thread block per 64-row q tile, 4x4 register tiles from shared
// memory, D / 16 output columns a thread (1 at D = 16; at D = 128 the
// shared memory is 2*128*68 + 64*132 + 64*68 floats, 118 KB). It runs only
// in the small fp32 references and the tiny test models.
//
// Row statistics for the backward (csrc/flash_attn_bwd.cu): when the
// caller passes `m_out`/`l_out` (fp32 [B,H,Tq]), the kernel also writes
// each row's final max m and sum l of exp(x - m), in natural-log units
// whatever the body computes in. They are kept apart, not folded into one
// log-sum-exp: on a row whose key length is 0 every logit is the finite
// -1e30, so m = -1e30 (written exactly) and l = Tk, and in fp32
// -1e30 + log(Tk) rounds back to -1e30, which would make the recomputed
// weights 1 instead of 1/Tk. With null pointers (serving) nothing else
// changes.
//
// Layout: Q [B,Tq,H,D], K/V [B,Tk,H,D] read through their batch/time/head
// strides (last dim contiguous), so no transpose copies; O is a
// contiguous [B,Tq,H,D] allocated by the caller. For bf16, TMA needs the
// base addresses and the strides to be multiples of 16 bytes.

#include "hopper_tiles.cuh"

namespace {

constexpr float MASKED = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED2 = MASKED * LOG2E;  // a masked logit in log2 units

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ------------------------------------------------------ fp32: FMA pipes

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int NT = 256;      // threads per block: a 16 x 16 grid
constexpr int PAD = 4;       // smem row padding (keeps float4 alignment)
constexpr int RS = BQ + PAD; // row stride of the transposed Q/K and of P

// Shared memory (floats): Qt [D][RS], Kt [D][RS], Vs [BK][D+PAD], Ps [BK][RS].
template <int D>
constexpr int smem_floats() {
  return 2 * D * RS + BK * (D + PAD) + BK * RS;
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              const int* __restrict__ lengths, int H, int Tq, int Tk,
              int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
              int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
              int64_t v_sh, float scale, int causal,
              float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int DC = D / 16;  // output columns per thread
  constexpr int VS = D + PAD;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;           // [D][RS]  Q tile, transposed
  float* Kt = Qt + D * RS;    // [D][RS]  K tile, transposed
  float* Vs = Kt + D * RS;    // [BK][VS] V tile
  float* Ps = Vs + BK * VS;   // [BK][RS] P tile, transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key group (S) / column group (O)
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const int len = lengths != nullptr ? lengths[b] : Tk;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qt[d * RS + r] = qi < Tq ? qb[qi * q_st + d] : 0.0f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // previous tile's PV is done with Kt/Vs/Ps
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int ki = k0 + r;
      const bool in = ki < Tk;
      Kt[d * RS + r] = in ? kb[ki * k_st + d] : 0.0f;
      Vs[r * VS + d] = in ? vb[ki * v_st + d] : 0.0f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4+i, keys k0 + tx*4+j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * RS + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * RS + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // scale, mask, online softmax (each row lives on 16 lanes of one warp)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float tmax = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && ki > qi) x = MASKED;
        if (ki >= len) x = MASKED;
        if (ki >= Tk) x = neg_inf();
        s[i][j] = x;
        tmax = fmaxf(tmax, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      // every tile holds at least one key < Tk, so m_new is finite
      const float m_new = fmaxf(m[i], tmax);
      const float alpha = expf(m[i] - m_new);
      float tsum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        tsum += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        tsum += __shfl_xor_sync(0xffffffffu, tsum, off);
      l[i] = l[i] * alpha + tsum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Ps + (tx * 4 + j) * RS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // O += P V for rows ty*4+i, columns tx*DC+j
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Ps + kk * RS + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      float cv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) cv[j] = Vs[kk * VS + tx * DC + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
  }

  // one division by the row sum; ragged q rows are masked on store
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tq) continue;
    if (m_out != nullptr && tx == 0) {  // all 16 lanes of a row agree
      const int64_t row = (int64_t(b) * H + h) * Tq + qi;
      m_out[row] = m[i];
      l_out[row] = l[i];
    }
    const float inv = 1.0f / l[i];
    float* orow = o + ((int64_t(b) * Tq + qi) * H + h) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) orow[j] = acc[i][j] * inv;
  }
}

// ------------------------------------------------ bf16: wgmma and TMA

constexpr int BN = 64;      // keys per K/V tile
constexpr int STAGES = 4;   // K/V ring depth

// Shared memory of the bf16 body, in bytes from a 1024-aligned base: the
// Q tile [64 * NWG][D], the K and V rings [STAGES][BN][D], then the
// mbarriers (Q, then one per K/V stage).
template <int D, int NWG>
struct FwdSmem {
  static constexpr int BM = 64 * NWG;
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int K = Q_BYTES;
  static constexpr int V = K + STAGES * KV_BYTES;
  static constexpr int BAR = V + STAGES * KV_BYTES;
  static constexpr int TOTAL = BAR + 8 * (1 + STAGES) + 1024;  // + alignment slack
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "tiles stay 1024-aligned");
  static_assert(D <= 64 || NWG == 1, "a tile of two sub-tiles has 64 rows");
  static_assert(TOTAL <= 232448, "fits the 227 KB a block can use");
};

template <int D, int NWG>
__global__ void __launch_bounds__(NWG * 128)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                const int* __restrict__ lengths, int H, int Tq, int Tk, float scale_log2,
                int causal, float* __restrict__ m_out, float* __restrict__ l_out) {
  using L = FwdSmem<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);  // Q, then K/V stages

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int t = tid % 128;
  const int c = t % 4;
  const int q0 = blockIdx.x * L::BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths != nullptr ? lengths[b] : Tk;
  const int lim = min(len, Tk);  // keys from here on are masked

  // key tiles that can carry weight (all of them for a row of key length 0)
  int kv_end = Tk;
  if (len > 0) {
    kv_end = lim;
    if (causal) kv_end = min(kv_end, min(q0 + L::BM, Tq));
  }
  const int n_tiles = (kv_end + BN - 1) / BN;

  auto load_kv = [&](int tile, int stage) {
    uint64_t* bar = &bars[1 + stage];
    hopper::mbar_expect_tx(bar, 2 * L::KV_BYTES);
    hopper::tma_load_tile<D>(smem + L::K + stage * L::KV_BYTES, &tm_k, bar, h, tile * BN, b, BN);
    hopper::tma_load_tile<D>(smem + L::V + stage * L::KV_BYTES, &tm_v, bar, h, tile * BN, b, BN);
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bars[0], L::Q_BYTES);
    hopper::tma_load_tile<D>(smem, &tm_q, &bars[0], h, q0, b, L::BM);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
  }
  __syncthreads();
  // this thread's two rows of its warpgroup's 64: row0 and row0 + 8
  const int row0 = q0 + 64 * wg + 16 * (t / 32) + (t % 32) / 4;
  const uint8_t* q_tile = smem + wg * 64 * D * 2;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.0f;
  float m_run[2] = {neg_inf(), neg_inf()};  // log2 units
  float l_run[2] = {0.0f, 0.0f};            // this thread's part of the row sum

  // Scale tile j's scores to log2 units, mask them (only edge tiles need
  // the compares), update the running max and sum, and leave
  // exp2(x - max) in sc; returns each row's rescale factor for O.
  // Inner tiles keep the raw scores and fold the scale into one FFMA a
  // score (the scale is positive, so the max commutes with it); edge
  // tiles scale and mask first and subtract exactly, which keeps a row of
  // key length 0 at exp2(MASKED2 - MASKED2) = 1.
  auto softmax = [&](float (&sc)[32], int j, float (&alpha)[2]) {
    const int k0 = j * BN;
    const bool edge = k0 + BN > lim || (causal && k0 + BN - 1 > q0);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
        float x = sc[e] * scale_log2;
        if (key >= lim || (causal && key > row0 + 8 * ((e >> 1) & 1))) x = MASKED2;
        if (key >= Tk) x = neg_inf();
        sc[e] = x;
      }
    }
    const float mul = edge ? 1.0f : scale_log2;
    float tmax[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int e = 0; e < 32; ++e) tmax[(e >> 1) & 1] = fmaxf(tmax[(e >> 1) & 1], sc[e]);
    // the 4 lanes of a quad share a row; every tile holds a key < Tk, so
    // the new max is finite
    float psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      const float m_new = fmaxf(m_run[i], tmax[i] * mul);
      alpha[i] = hopper::exp2_approx(m_run[i] - m_new);
      m_run[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      sc[e] = hopper::exp2_approx(fmaf(sc[e], mul, -m_run[i]));
      psum[i] += sc[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + psum[i];
  };
  auto k_tile = [&](int s) { return smem + L::K + s * L::KV_BYTES; };
  auto v_tile = [&](int s) { return smem + L::V + s * L::KV_BYTES; };

  hopper::mbar_wait(&bars[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    float sc[32], alpha[2];
    hopper::wgmma_fence();
    hopper::gemm_nt<D>(sc, q_tile, k_tile(s));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    softmax(sc, j, alpha);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

    // O += P V, P rounded to bf16 as the A operand
    uint32_t pa[16];
    hopper::pack_a(sc, pa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    hopper::gemm_pv<D>(acc, pa, v_tile(s));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();  // every warpgroup is done with stage s
    if (tid == 0 && j + STAGES < n_tiles) load_kv(j + STAGES, s);
  }

  // one division by the row sum; rows past Tq are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    const int qi = row0 + 8 * i;
    if (qi >= Tq) continue;
    if (m_out != nullptr && c == 0) {
      const int64_t row = (int64_t(b) * H + h) * Tq + qi;
      m_out[row] = m_run[i] == MASKED2 ? MASKED : m_run[i] * LN2;
      l_out[row] = l_run[i];
    }
    const float inv = 1.0f / l_run[i];
    __nv_bfloat16* orow = o + ((int64_t(b) * Tq + qi) * H + h) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  const int* lengths;
  int B, H, Tq, Tk;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  float scale;
  int causal;
  float *m, *l;
};

template <int D>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  flash_fwd_fma<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lengths, a.H, a.Tq, a.Tk,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.scale,
      a.causal, a.m, a.l);
  return cudaGetLastError();
}

template <int D, int NWG>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  using L = FwdSmem<D, NWG>;
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::encode_bthd(&tq, a.q, a.B, a.Tq, a.H, D, a.q_sb, a.q_st, a.q_sh, L::BM);
  if (err == cudaSuccess)
    err = hopper::encode_bthd(&tk, a.k, a.B, a.Tk, a.H, D, a.k_sb, a.k_st, a.k_sh, BN);
  if (err == cudaSuccess)
    err = hopper::encode_bthd(&tv, a.v, a.B, a.Tk, a.H, D, a.v_sb, a.v_st, a.v_sh, BN);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<D, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::TOTAL);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + L::BM - 1) / L::BM, a.H, a.B);
  flash_fwd_wgmma<D, NWG><<<grid, NWG * 128, L::TOTAL, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.lengths, a.H, a.Tq, a.Tk,
      a.scale * LOG2E, a.causal, a.m, a.l);
  return cudaGetLastError();
}

// 128 q rows a block when that grid still gives every SM a block, else 64
// (always 64 at D = 128)
template <int D>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  if (D > 64) return launch_wgmma<D, 1>(a, stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t blocks128 = int64_t((a.Tq + 127) / 128) * a.H * a.B;
  return blocks128 >= sms ? launch_wgmma<D, (D > 64 ? 1 : 2)>(a, stream)
                          : launch_wgmma<D, 1>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lengths` is
// a device int32 [B] or null. `m_out`/`l_out` are device fp32 [B,H,Tq]
// for the row statistics, or both null. Returns the cudaError_t of the
// launch (0 on success); an unsupported D or dtype (both take D 16, 32,
// 64 and 128), or bf16 operands that TMA cannot read (base or
// strides not multiples of 16 bytes), return cudaErrorInvalidValue.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, const void* lengths, int B, int H,
                              int Tq, int Tk, int D, int dtype, long long q_sb,
                              long long q_st, long long q_sh, long long k_sb,
                              long long k_st, long long k_sh, long long v_sb,
                              long long v_st, long long v_sh, float scale,
                              int causal, void* m_out, void* l_out,
                              void* stream) {
  const Args a{q, k, v, o, static_cast<const int*>(lengths), B, H, Tq, Tk,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal,
               static_cast<float*>(m_out), static_cast<float*>(l_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((a.m == nullptr) != (a.l == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && D == 128) return static_cast<int>(launch_fma<128>(a, s));
  if (dtype == 0 && D == 64) return static_cast<int>(launch_fma<64>(a, s));
  if (dtype == 0 && D == 32) return static_cast<int>(launch_fma<32>(a, s));
  if (dtype == 0 && D == 16) return static_cast<int>(launch_fma<16>(a, s));
  if (dtype == 1 && D == 128) return static_cast<int>(launch_bf16<128>(a, s));
  if (dtype == 1 && D == 64) return static_cast<int>(launch_bf16<64>(a, s));
  if (dtype == 1 && D == 32) return static_cast<int>(launch_bf16<32>(a, s));
  if (dtype == 1 && D == 16) return static_cast<int>(launch_bf16<16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
