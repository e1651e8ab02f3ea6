// Flash-attention backward for Hopper (sm_90a), CUDA C++, plain C entry.
//
// Replaces the TPU kernel `_attn_bwd_kernel` launched by `_flash_bwd_pallas`
// in avsl_tpu/kernels/attention.py (the custom VJP of `fused_attention`).
// Given Q, K, V, the forward's output O, the output gradient dO, and the
// forward's row statistics m (row max of the scaled, masked logits) and
// l (row sum of exp(x - m)) written by csrc/flash_attn_fwd.cu, it computes
//   P  = exp(x - m) / l,   x = Q K^T / sqrt(D) with the forward's masking
//   dV = P^T dO
//   dS = P * (dO V^T - rowsum(dO * O)) / sqrt(D)
//   dQ = dS K,   dK = dS^T Q
// and writes each result once, cast to the input type. Masking is the
// forward's: causal (k <= q) and key-length masks give the finite logit
// -1e30, so a row with key length 0 has m = -1e30, l = Tk and weights 1/Tk
// on every key, and its dS is formed at every key as the TPU kernel forms
// it; keys past Tk and q rows past Tq get weight 0.
//
// What bounds it: the five products are 10*B*H*Tq*Tk*D FLOP against Q, K,
// V, O, dO read and dQ, dK, dV written once; at the training encoder shape
// (B=1, H=20, T=500, D=64, bf16) that is 3.2e9 FLOP against 10 MB, far
// above the H100's ~295 FLOP/byte ridge, so it is bound by arithmetic, and
// only the tensor cores (989 TFLOP/s bf16) come near the bound.
//
// Structure. The TPU kernel holds all of K/V in VMEM and carries dK/dV in
// fp32 across a sequential grid axis of q blocks. CUDA blocks run in
// parallel and in no order, so that carried sum becomes a loop inside one
// block, and the work splits into three passes with no atomics (the
// results are the same from run to run):
//   (a) delta: one warp per (b, h, q row) sums dO * O over D in fp32;
//   (b) dK/dV: one block per (64-key tile, head, batch) keeps its K and V
//       tile in shared memory, loops over the 64-row q tiles, recomputes
//       P^T and dP^T for the tile pair, and accumulates dV += P^T dO and
//       dK += dS^T Q in registers;
//   (c) dQ: one block per (64-row q tile, head, batch) keeps its Q and dO
//       tile, loops over the key tiles and accumulates dQ += dS K.
// Tile pairs whose weights are all exactly 0 are skipped: under the causal
// mask the q tiles wholly before a key tile, under a key length the key
// tiles wholly past it. Neither applies to a row of key length 0.
// Q/K/V/O/dO are read through their [B,T,H,D] strides (last dim
// contiguous), so the wrapper makes no transpose copies; dQ/dK/dV are
// contiguous [B,T,H,D].
//
// bf16 design (the training path's type), D in {16, 32, 64, 128}: (b) and (c)
// are one launch whose blocks are one warpgroup (128 threads) each, the first
// ceil(Tk / 64) along x doing (b) and the rest (c), so at the training
// path's batch of 1 both halves fill the card together (1,20,500,500
// gives 160 + 160 blocks); every product runs on wgmma
// with fp32 accumulators (csrc/hopper_tiles.cuh). (b) works in the
// transposed frame, as FlashAttention-2/3 do, so that every A operand is
// a shared-memory tile or an accumulator already in A-fragment layout:
// S^T = K Q^T and dP^T = V dO^T (A and B K-major), then
// P^T = exp2(S^T log2e / sqrt(D) - m) / l with per-column m, 1/l and delta
// staged in shared memory, dS^T = P^T (dP^T - delta), and dV += P^T dO,
// dK += dS^T Q with A from registers and B = the dO / Q tile MN-major.
// (c) computes S = Q K^T and dP = dO V^T, then dQ += dS K with B = the K
// tile MN-major. The 1/sqrt(D) of dS is applied once to the dK and dQ
// accumulators (exact at D = 64, where it is 1/8). The tiles come by TMA into
// rings of STAGES stages completing on mbarriers, thread 0 issuing the
// loads STAGES - 1 tiles ahead. P and dS are rounded to bf16 only as
// product operands; everything else stays fp32 as in the TPU kernel. The
// forward's m arrives in natural-log units and is taken to log2 units
// here, the masked -1e30 exactly to its log2 image, so a length-0 row
// still gets weights 1/Tk.
// At D = 128 (the AV-HuBERT decoder's 8 heads of 1024) a block is two
// warpgroups: both compute the tile pair's S and dP over the full D
// (every tile is two [64][64] sub-tiles, csrc/hopper_tiles.cuh), and each
// accumulates dK, dV (or dQ) for one 64-column half, on that half of the
// dO / Q (or K) tile. So a thread keeps D = 64's registers: dK and dV of
// 64 x 128 in one warpgroup would be 128 fp32 accumulators a thread
// beside S and dP, past the 255 a thread can have. The S and dP
// products are computed twice, which the tensor cores can spare at these
// sequence lengths.
// At D = 16 the tiles are 32-byte rows (32-byte swizzle): S^T, dP^T, S and
// dP are one m64n64k16 product each, and the dV, dK and dQ chains are
// m64n16k16 (csrc/hopper_tiles.cuh).
// fp32 operands keep the first version's bodies on the FMA pipes (4x4
// register tiles from shared memory, 256 threads a block, D / 16
// accumulator columns a thread): the bf16 tensor cores would change their
// result. They run only in the small fp32 references and the tiny test
// models.

#include "hopper_tiles.cuh"

namespace {

constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // keys per tile
constexpr int NT = 256;      // threads per block: a 16 x 16 grid
constexpr int PAD = 4;       // smem row padding (keeps float4 alignment)
constexpr int RS = BQ + PAD; // row stride of transposed tiles and of P/dS
constexpr float MASKED = -1.0e30f;

static_assert(BQ == BK, "the causal tile skipping assumes square tiles");

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// (a) delta[b,h,q] = sum_d dO[b,q,h,d] * O[b,q,h,d] in fp32; one warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
             float* __restrict__ delta, int B, int H, int Tq, int64_t o_sb,
             int64_t o_st, int64_t o_sh, int64_t g_sb, int64_t g_st,
             int64_t g_sh) {
  const int64_t row = int64_t(blockIdx.x) * (NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= int64_t(B) * H * Tq) return;  // whole warps leave together
  const int qi = static_cast<int>(row % Tq);
  const int h = static_cast<int>((row / Tq) % H);
  const int b = static_cast<int>(row / (int64_t(Tq) * H));
  const T* orow = o + b * o_sb + qi * o_st + h * o_sh;
  const T* grow = g + b * g_sb + qi * g_st + h * g_sh;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(load_f(grow + d), load_f(orow + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Shared memory of (b) and (c), in floats: four transposed tiles [D][RS]
// (in (b) two of them are re-used as [64][RS] P/dS tiles, hence max(D, 64)
// rows), two more tiles of [64][max(D + PAD, RS)] (row-major [64][D + PAD]
// tiles, and in (c) the [64][RS] dS tile), and three per-row vectors. At
// D = 128 that is 51,904 floats (203 KB, under the 227 KB opt-in limit).
template <int D>
constexpr int bwd_smem_floats() {
  constexpr int row = D + PAD > RS ? D + PAD : RS;
  static_assert(sizeof(float) * (4 * (D > BQ ? D : BQ) * RS + 2 * BQ * row + 3 * BQ) <= 232448,
                "fits the 227 KB a block can use");
  return 4 * (D > BQ ? D : BQ) * RS + 2 * BQ * row + 3 * BQ;
}

// (b) one block per (64-key tile, head, batch): dK and dV of the tile.
template <int D>
__global__ void __launch_bounds__(NT)
dkdv_fma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            const float* __restrict__ delta, const int* __restrict__ lengths,
            float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
            int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
            int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
            int64_t v_sh, int64_t g_sb, int64_t g_st, int64_t g_sh,
            float scale, int causal) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  constexpr int VS = D + PAD;
  constexpr int TS = (D > BQ ? D : BQ) * RS;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;          // [D][RS]  K tile, transposed
  float* Vt = Kt + TS;       // [D][RS]  V tile, transposed
  float* Qt = Vt + TS;       // [D][RS]  Q tile, transposed; then P  [q][RS]
  float* Gt = Qt + TS;       // [D][RS]  dO tile, transposed; then dS [q][RS]
  float* Qr = Gt + TS;       // [BQ][VS] Q tile, row-major
  float* Gr = Qr + BQ * VS;  // [BQ][VS] dO tile, row-major
  float* ms = Gr + BQ * VS;  // [BQ] row max
  float* ls = ms + BQ;       // [BQ] 1 / row sum
  float* ds_ = ls + BQ;      // [BQ] delta
  float* Ps = Qt;
  float* Ss = Gt;

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // q group (scores) / column group (accumulators)
  const int ty = tid >> 4;  // key group: keys ty*4 .. ty*4+3
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths != nullptr ? lengths[b] : Tk;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* gb = g + b * g_sb + h * g_sh;
  const int64_t stat0 = (int64_t(b) * H + h) * Tq;

  for (int idx = tid; idx < BK * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int ki = k0 + r;
    const bool in = ki < Tk;
    Kt[d * RS + r] = in ? load_f(kb + ki * k_st + d) : 0.0f;
    Vt[d * RS + r] = in ? load_f(vb + ki * v_st + d) : 0.0f;
  }

  float acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // q tiles whose weights on this key tile can be nonzero (a length-0 row
  // weighs every key, so nothing is skipped for it)
  int q_begin = 0, q_end = Tq;
  if (len > 0) {
    if (k0 >= len) q_end = 0;            // every key of the tile is masked
    else if (causal) q_begin = k0;       // rows q < k0 see none of it
  }

  for (int q0 = q_begin; q0 < q_end; q0 += BQ) {
    __syncthreads();  // the previous tile's accumulation is done with smem
    for (int idx = tid; idx < BQ * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int qi = q0 + r;
      const bool in = qi < Tq;
      const float qv = in ? load_f(qb + qi * q_st + d) : 0.0f;
      const float gv = in ? load_f(gb + qi * g_st + d) : 0.0f;
      Qt[d * RS + r] = qv;
      Qr[r * VS + d] = qv;
      Gt[d * RS + r] = gv;
      Gr[r * VS + d] = gv;
    }
    for (int r = tid; r < BQ; r += NT) {
      const int qi = q0 + r;
      const bool in = qi < Tq;
      ms[r] = in ? m_in[stat0 + qi] : 0.0f;
      ls[r] = in ? 1.0f / l_in[stat0 + qi] : 0.0f;
      ds_[r] = in ? delta[stat0 + qi] : 0.0f;
    }
    __syncthreads();

    // S^T and dP^T for keys ty*4+i, q rows tx*4+j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 kk = *reinterpret_cast<const float4*>(Kt + d * RS + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(Vt + d * RS + ty * 4);
      const float4 qq = *reinterpret_cast<const float4*>(Qt + d * RS + tx * 4);
      const float4 gg = *reinterpret_cast<const float4*>(Gt + d * RS + tx * 4);
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
      const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[j], ka[i], s[i][j]);
          dp[i][j] = fmaf(ga[j], va[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ki = k0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx * 4 + j;
        const int qi = q0 + r;
        float x = s[i][j] * scale;
        if (causal && ki > qi) x = MASKED;
        if (ki >= len) x = MASKED;
        const float p = (ki < Tk && qi < Tq) ? expf(x - ms[r]) * ls[r] : 0.0f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - ds_[r]) * scale;
      }
    }
    __syncthreads();  // everyone is done reading Qt/Gt: reuse them for P/dS
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx * 4 + j;
      *reinterpret_cast<float4*>(Ps + r * RS + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(Ss + r * RS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for keys ty*4+i, columns tx*DC+j
#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      const float4 pp = *reinterpret_cast<const float4*>(Ps + r * RS + ty * 4);
      const float4 ss = *reinterpret_cast<const float4*>(Ss + r * RS + ty * 4);
      const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
      const float sa[4] = {ss.x, ss.y, ss.z, ss.w};
      float gv[DC], qv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        gv[j] = Gr[r * VS + tx * DC + j];
        qv[j] = Qr[r * VS + tx * DC + j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          acc_v[i][j] = fmaf(pa[i], gv[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(sa[i], qv[j], acc_k[i][j]);
        }
    }
  }

  // written once, cast to the input type; keys past Tk are not stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= Tk) continue;
    const int64_t off = ((int64_t(b) * Tk + ki) * H + h) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      dk[off + j] = acc_k[i][j];
      dv[off + j] = acc_v[i][j];
    }
  }
}

// (c) one block per (64-row q tile, head, batch): dQ of the tile.
template <int D>
__global__ void __launch_bounds__(NT)
dq_fma(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          const float* __restrict__ delta, const int* __restrict__ lengths,
          float* __restrict__ dq, int H, int Tq, int Tk, int64_t q_sb,
          int64_t q_st, int64_t q_sh, int64_t k_sb, int64_t k_st,
          int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
          int64_t g_sb, int64_t g_st, int64_t g_sh, float scale, int causal) {
  constexpr int DC = D / 16;
  constexpr int VS = D + PAD;
  constexpr int TS = (D > BQ ? D : BQ) * RS;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;          // [D][RS]  Q tile, transposed
  float* Gt = Qt + TS;       // [D][RS]  dO tile, transposed
  float* Kt = Gt + TS;       // [D][RS]  K tile, transposed
  float* Vt = Kt + TS;       // [D][RS]  V tile, transposed
  float* Kr = Vt + TS;       // [BK][VS] K tile, row-major
  float* Ss = Kr + BK * VS;  // [BK][RS] dS tile, key-major
  float* ms = Ss + BK * RS;  // [BQ] row max
  float* ls = ms + BQ;       // [BQ] 1 / row sum
  float* ds_ = ls + BQ;      // [BQ] delta

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // key group (scores) / column group (dQ)
  const int ty = tid >> 4;  // q rows ty*4 .. ty*4+3
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths != nullptr ? lengths[b] : Tk;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + h * k_sh;
  const float* vb = v + b * v_sb + h * v_sh;
  const float* gb = g + b * g_sb + h * g_sh;
  const int64_t stat0 = (int64_t(b) * H + h) * Tq;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    const bool in = qi < Tq;
    Qt[d * RS + r] = in ? load_f(qb + qi * q_st + d) : 0.0f;
    Gt[d * RS + r] = in ? load_f(gb + qi * g_st + d) : 0.0f;
  }
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    const bool in = qi < Tq;
    ms[r] = in ? m_in[stat0 + qi] : 0.0f;
    ls[r] = in ? 1.0f / l_in[stat0 + qi] : 0.0f;
    ds_[r] = in ? delta[stat0 + qi] : 0.0f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.0f;

  // key tiles that can carry weight for these rows (none skipped for a
  // row of key length 0)
  int k_end = Tk;
  if (len > 0) {
    if (len < k_end) k_end = len;
    if (causal) {
      const int q_last = (q0 + BQ < Tq ? q0 + BQ : Tq) - 1;
      if (q_last + 1 < k_end) k_end = q_last + 1;
    }
  }

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's accumulation is done with smem
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int ki = k0 + r;
      const bool in = ki < Tk;
      const float kv = in ? load_f(kb + ki * k_st + d) : 0.0f;
      Kt[d * RS + r] = kv;
      Kr[r * VS + d] = kv;
      Vt[d * RS + r] = in ? load_f(vb + ki * v_st + d) : 0.0f;
    }
    __syncthreads();

    // S and dP for q rows ty*4+i, keys tx*4+j (the forward's order of sums)
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qq = *reinterpret_cast<const float4*>(Qt + d * RS + ty * 4);
      const float4 gg = *reinterpret_cast<const float4*>(Gt + d * RS + ty * 4);
      const float4 kk = *reinterpret_cast<const float4*>(Kt + d * RS + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(Vt + d * RS + tx * 4);
      const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
      const float ga[4] = {gg.x, gg.y, gg.z, gg.w};
      const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx * 4 + j;
        float x = s[i][j] * scale;
        if (causal && ki > qi) x = MASKED;
        if (ki >= len) x = MASKED;
        const float p = (ki < Tk && qi < Tq) ? expf(x - ms[r]) * ls[r] : 0.0f;
        dp[i][j] = p * (dp[i][j] - ds_[r]) * scale;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Ss + (tx * 4 + j) * RS + ty * 4) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    }
    __syncthreads();

    // dQ += dS K for q rows ty*4+i, columns tx*DC+j
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 ss = *reinterpret_cast<const float4*>(Ss + kk * RS + ty * 4);
      const float sa[4] = {ss.x, ss.y, ss.z, ss.w};
      float kv[DC];
#pragma unroll
      for (int j = 0; j < DC; ++j) kv[j] = Kr[kk * VS + tx * DC + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(sa[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Tq) continue;
    float* row = dq + ((int64_t(b) * Tq + qi) * H + h) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) row[j] = acc[i][j];
  }
}

// ------------------------------------------------ bf16: wgmma and TMA

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED2 = MASKED * LOG2E;  // a masked logit in log2 units
constexpr int BT = 64;       // rows of every bf16 tile: 64 keys or 64 q rows
constexpr int STAGES = 3;    // ring depth of the tiles a block loops over

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// The forward's row max m (natural units) in the log2 units the bf16
// bodies compute in; the masked -1e30 maps exactly to MASKED2, so a row of
// key length 0 gets exp2(MASKED2 - MASKED2) = 1, weight 1/l.
__device__ __forceinline__ float m_log2(float m) { return m == MASKED ? MASKED2 : m * LOG2E; }

// Shared memory of (b), bytes from a 1024-aligned base: the K and V tiles,
// a ring of STAGES (Q, dO) tile pairs, a ring of STAGES per-row vectors
// (m in log2 units, 1 / l, delta) for the pair's 64 q rows, the mbarriers
// (K/V, then one per stage).
// warpgroups a block of the bf16 bodies, and the accumulator columns of each
template <int D>
struct BwdWarps {
  static constexpr int NWG = D > 64 ? 2 : 1;
  static constexpr int DA = D / NWG;
};

template <int D>
struct DkdvSmem {
  static constexpr int TILE = BT * D * 2;
  static constexpr int RING = 2 * TILE;  // stage s: Q at RING + 2s TILE, dO after it
  static constexpr int STAT = RING + STAGES * 2 * TILE;
  static constexpr int BAR = STAT + STAGES * 3 * BT * 4;
  static constexpr int TOTAL = BAR + 8 * (1 + STAGES) + 1024;
  static_assert(TILE % 1024 == 0, "tiles stay 1024-aligned");
  static_assert(TOTAL <= 232448, "fits the 227 KB a block can use");
};

// (b) one block (a warpgroup, two at D = 128) per (64-key tile, head,
// batch), in the transposed frame: for each q tile, S^T = K Q^T and dP^T
// = V dO^T (both operands K-major), P^T and dS^T in registers, then dV +=
// P^T dO and dK += dS^T Q with A from registers and B = the dO / Q tile
// (warpgroup w: its columns w DA ..) MN-major.
template <int D>
__device__ __forceinline__ void dkdv_tile(
    int tile, const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_g, const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk,
    float scale, float scale_log2, int causal) {
  using L = DkdvSmem<D>;
  constexpr int DA = BwdWarps<D>::DA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* stats = reinterpret_cast<float*>(smem + L::STAT);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // the accumulator columns wg * DA ..
  const int t = tid % 128;
  const int c = t % 4;
  const int k0 = tile * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths != nullptr ? lengths[b] : Tk;
  const int lim = min(len, Tk);
  const int64_t stat0 = (int64_t(b) * H + h) * Tq;

  // q tiles whose weights on this key tile can be nonzero (a length-0 row
  // weighs every key, so nothing is skipped for it)
  int q_begin = 0, q_end = Tq;
  if (len > 0) {
    if (k0 >= len) q_end = 0;       // every key of the tile is masked
    else if (causal) q_begin = k0;  // rows q < k0 see none of it
  }
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + BT - 1) / BT : 0;

  auto load_qg = [&](int tile, int stage) {
    uint64_t* bar = &bars[1 + stage];
    uint8_t* dst = smem + L::RING + stage * 2 * L::TILE;
    hopper::mbar_expect_tx(bar, 2 * L::TILE);
    hopper::tma_load_tile<D>(dst, &tm_q, bar, h, q_begin + tile * BT, b, BT);
    hopper::tma_load_tile<D>(dst + L::TILE, &tm_g, bar, h, q_begin + tile * BT, b, BT);
  };
  auto load_stats = [&](int tile, int stage) {  // threads 0..63, one q row each
    const int qi = q_begin + tile * BT + tid;
    float* st = stats + stage * 3 * BT;
    const bool in = qi < Tq;  // rows past Tq get weight 0
    st[tid] = in ? m_log2(m_in[stat0 + qi]) : pos_inf();
    st[BT + tid] = in ? 1.0f / l_in[stat0 + qi] : 0.0f;
    st[2 * BT + tid] = in ? delta[stat0 + qi] : 0.0f;
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bars[0], 2 * L::TILE);
    hopper::tma_load_tile<D>(smem, &tm_k, &bars[0], h, k0, b, BT);
    hopper::tma_load_tile<D>(smem + L::TILE, &tm_v, &bars[0], h, k0, b, BT);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_qg(s, s);
  }
  if (tid < BT)
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_stats(s, s);
  __syncthreads();

  const int key0 = k0 + 16 * (t / 32) + (t % 32) / 4;  // this thread's keys: key0, key0 + 8
  float acc_v[DA / 2], acc_k[DA / 2];
#pragma unroll
  for (int e = 0; e < DA / 2; ++e) acc_v[e] = acc_k[e] = 0.0f;

  hopper::mbar_wait(&bars[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    const uint8_t* q_tile = smem + L::RING + s * 2 * L::TILE;
    const uint8_t* g_tile = q_tile + L::TILE;
    const float* st = stats + s * 3 * BT;

    float p[32], ds[32];
    hopper::wgmma_fence();
    hopper::gemm_nt<D>(p, smem, q_tile);            // S^T = K Q^T
    hopper::gemm_nt<D>(ds, smem + L::TILE, g_tile);  // dP^T = V dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
    hopper::fence_regs(ds);

    const int qt0 = q_begin + j * BT;
    const bool edge = k0 + BT > lim || (causal && k0 + BT - 1 > qt0);
    // as in the forward: inner tiles fold the scale into one FFMA, edge
    // tiles mask the scaled logits and subtract exactly
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = key0 + 8 * ((e >> 1) & 1);
        const int ql = 8 * (e >> 2) + 2 * c + (e & 1);
        p[e] = (key >= lim || (causal && key > qt0 + ql)) ? MASKED2 : p[e] * scale_log2;
      }
    }
    const float mul = edge ? 1.0f : scale_log2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // this thread's q rows 8n + 2c and 8n + 2c + 1
      const float2 m2 = *reinterpret_cast<const float2*>(st + 8 * n + 2 * c);
      const float2 linv = *reinterpret_cast<const float2*>(st + BT + 8 * n + 2 * c);
      const float2 dl = *reinterpret_cast<const float2*>(st + 2 * BT + 8 * n + 2 * c);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 4 * n + r;
        const bool odd = r & 1;
        p[e] = hopper::exp2_approx(fmaf(p[e], mul, -(odd ? m2.y : m2.x))) * (odd ? linv.y : linv.x);
        ds[e] = p[e] * (ds[e] - (odd ? dl.y : dl.x));  // the 1/sqrt(D) goes on dK at the end
      }
    }

    // dV += P^T dO and dK += dS^T Q, P and dS rounded to bf16 as operands
    uint32_t pa[16], dsa[16];
    hopper::pack_a(p, pa);
    hopper::pack_a(ds, dsa);
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);
    hopper::wgmma_fence();
    hopper::gemm_pv<DA>(acc_v, pa, g_tile + wg * (BT * DA * 2));
    hopper::gemm_pv<DA>(acc_k, dsa, q_tile + wg * (BT * DA * 2));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_v);
    hopper::fence_regs(acc_k);

    __syncthreads();  // the whole block is done with stage s
    if (j + STAGES < n_tiles) {
      if (tid == 0) load_qg(j + STAGES, s);
      if (tid < BT) load_stats(j + STAGES, s);
    }
  }

  // written once, cast to bf16; keys past Tk are not stored
#pragma unroll
  for (int e = 0; e < DA / 2; ++e) acc_k[e] *= scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int ki = key0 + 8 * i;
    if (ki >= Tk) continue;
    const int64_t off = ((int64_t(b) * Tk + ki) * H + h) * D + wg * DA + 2 * c;
#pragma unroll
    for (int n = 0; n < DA / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * n) =
          __floats2bfloat162_rn(acc_k[4 * n + 2 * i], acc_k[4 * n + 2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * n) =
          __floats2bfloat162_rn(acc_v[4 * n + 2 * i], acc_v[4 * n + 2 * i + 1]);
    }
  }
}

// Shared memory of (c), bytes from a 1024-aligned base: the Q and dO
// tiles, a ring of STAGES (K, V) tile pairs, the mbarriers.
template <int D>
struct DqSmem {
  static constexpr int TILE = BT * D * 2;
  static constexpr int RING = 2 * TILE;  // stage s: K at RING + 2s TILE, V after it
  static constexpr int BAR = RING + STAGES * 2 * TILE;
  static constexpr int TOTAL = BAR + 8 * (1 + STAGES) + 1024;
};

// (c) one block (a warpgroup, two at D = 128) per (64-row q tile, head,
// batch): S = Q K^T and dP = dO V^T for each key tile, dS in registers,
// dQ += dS K with B = the K tile (warpgroup w: its columns w DA ..)
// MN-major.
template <int D>
__device__ __forceinline__ void dq_tile(
    int tile, const CUtensorMap& tm_q, const CUtensorMap& tm_k, const CUtensorMap& tm_v,
    const CUtensorMap& tm_g, const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ delta, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ dq, int H, int Tq, int Tk, float scale, float scale_log2,
    int causal) {
  using L = DqSmem<D>;
  constexpr int DA = BwdWarps<D>::DA;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // the accumulator columns wg * DA ..
  const int t = tid % 128;
  const int c = t % 4;
  const int q0 = tile * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int len = lengths != nullptr ? lengths[b] : Tk;
  const int lim = min(len, Tk);

  // key tiles that can carry weight for these rows (none skipped for a
  // row of key length 0)
  int k_end = Tk;
  if (len > 0) {
    k_end = lim;
    if (causal) k_end = min(k_end, min(q0 + BT, Tq));
  }
  const int n_tiles = (k_end + BT - 1) / BT;

  auto load_kv = [&](int tile, int stage) {
    uint64_t* bar = &bars[1 + stage];
    uint8_t* dst = smem + L::RING + stage * 2 * L::TILE;
    hopper::mbar_expect_tx(bar, 2 * L::TILE);
    hopper::tma_load_tile<D>(dst, &tm_k, bar, h, tile * BT, b, BT);
    hopper::tma_load_tile<D>(dst + L::TILE, &tm_v, bar, h, tile * BT, b, BT);
  };
  if (tid == 0) {
    for (int i = 0; i <= STAGES; ++i) hopper::mbar_init(&bars[i], 1);
    hopper::fence_barrier_init();
    hopper::mbar_expect_tx(&bars[0], 2 * L::TILE);
    hopper::tma_load_tile<D>(smem, &tm_q, &bars[0], h, q0, b, BT);
    hopper::tma_load_tile<D>(smem + L::TILE, &tm_g, &bars[0], h, q0, b, BT);
    for (int s = 0; s < STAGES && s < n_tiles; ++s) load_kv(s, s);
  }

  // this thread's rows row0 and row0 + 8, and their statistics
  const int row0 = q0 + 16 * (t / 32) + (t % 32) / 4;
  const int64_t stat0 = (int64_t(b) * H + h) * Tq;
  float m2[2], linv[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    const bool in = qi < Tq;  // rows past Tq get weight 0
    m2[i] = in ? m_log2(m_in[stat0 + qi]) : pos_inf();
    linv[i] = in ? 1.0f / l_in[stat0 + qi] : 0.0f;
    dl[i] = in ? delta[stat0 + qi] : 0.0f;
  }
  __syncthreads();

  float acc[DA / 2];
#pragma unroll
  for (int e = 0; e < DA / 2; ++e) acc[e] = 0.0f;

  hopper::mbar_wait(&bars[0], 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    hopper::mbar_wait(&bars[1 + s], (j / STAGES) & 1);
    const uint8_t* k_tile = smem + L::RING + s * 2 * L::TILE;
    const uint8_t* v_tile = k_tile + L::TILE;

    float p[32], ds[32];
    hopper::wgmma_fence();
    hopper::gemm_nt<D>(p, smem, k_tile);            // S = Q K^T
    hopper::gemm_nt<D>(ds, smem + L::TILE, v_tile);  // dP = dO V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(p);
    hopper::fence_regs(ds);

    const int k0 = j * BT;
    const bool edge = k0 + BT > lim || (causal && k0 + BT - 1 > q0);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int key = k0 + 8 * (e >> 2) + 2 * c + (e & 1);
        const bool masked = key >= lim || (causal && key > row0 + 8 * ((e >> 1) & 1));
        p[e] = key >= Tk ? neg_inf() : masked ? MASKED2 : p[e] * scale_log2;
      }
    }
    const float mul = edge ? 1.0f : scale_log2;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int i = (e >> 1) & 1;
      // keys past Tk (TMA's zero fill) get -inf: weight 0 even on a row of
      // key length 0
      const float w = hopper::exp2_approx(fmaf(p[e], mul, -m2[i])) * linv[i];
      ds[e] = w * (ds[e] - dl[i]);  // the 1/sqrt(D) goes on dQ at the end
    }

    // dQ += dS K, dS rounded to bf16 as the operand
    uint32_t dsa[16];
    hopper::pack_a(ds, dsa);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    hopper::gemm_pv<DA>(acc, dsa, k_tile + wg * (BT * DA * 2));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);

    __syncthreads();  // the whole block is done with stage s
    if (tid == 0 && j + STAGES < n_tiles) load_kv(j + STAGES, s);
  }

#pragma unroll
  for (int e = 0; e < DA / 2; ++e) acc[e] *= scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    if (qi >= Tq) continue;
    __nv_bfloat16* row = dq + ((int64_t(b) * Tq + qi) * H + h) * D + wg * DA + 2 * c;
#pragma unroll
    for (int n = 0; n < DA / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

// (b) and (c) in one launch: blocks x < ceil(Tk / 64) take a key tile, the
// rest a q tile, so at small batch both halves fill the card together.
template <int D>
__global__ void __launch_bounds__(BwdWarps<D>::NWG * 128)
bwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          const float* __restrict__ delta, const int* __restrict__ lengths,
          __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
          __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale, float scale_log2,
          int causal) {
  const int key_tiles = (Tk + BT - 1) / BT;
  if (int(blockIdx.x) < key_tiles)
    dkdv_tile<D>(blockIdx.x, tm_q, tm_k, tm_v, tm_g, m_in, l_in, delta, lengths, dk, dv, H, Tq,
                 Tk, scale, scale_log2, causal);
  else
    dq_tile<D>(blockIdx.x - key_tiles, tm_q, tm_k, tm_v, tm_g, m_in, l_in, delta, lengths, dq,
               H, Tq, Tk, scale, scale_log2, causal);
}

struct Args {
  const void *q, *k, *v, *o, *g;
  const float *m, *l;
  float* delta;
  const int* lengths;
  void *dq, *dk, *dv;
  int B, H, Tq, Tk;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh, g_sb, g_st, g_sh;
  float scale;
  int causal;
};

template <typename T, int D>
cudaError_t launch_delta(const Args& a, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.Tq;
  const int64_t delta_blocks = (rows + NT / 32 - 1) / (NT / 32);
  delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), NT, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.delta, a.B,
      a.H, a.Tq, a.o_sb, a.o_st, a.o_sh, a.g_sb, a.g_st, a.g_sh);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma(const Args& a, cudaStream_t stream) {
  cudaError_t err = launch_delta<float, D>(a, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * bwd_smem_floats<D>();
  err = cudaFuncSetAttribute(dkdv_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  const float *q = static_cast<const float*>(a.q), *k = static_cast<const float*>(a.k),
              *v = static_cast<const float*>(a.v), *g = static_cast<const float*>(a.g);
  dim3 kgrid((a.Tk + BK - 1) / BK, a.H, a.B);
  dkdv_fma<D><<<kgrid, NT, smem, stream>>>(
      q, k, v, g, a.m, a.l, a.delta, a.lengths, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.H, a.Tq, a.Tk, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st,
      a.k_sh, a.v_sb, a.v_st, a.v_sh, a.g_sb, a.g_st, a.g_sh, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 qgrid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  dq_fma<D><<<qgrid, NT, smem, stream>>>(
      q, k, v, g, a.m, a.l, a.delta, a.lengths, static_cast<float*>(a.dq), a.H, a.Tq, a.Tk,
      a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.g_sb, a.g_st,
      a.g_sh, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = hopper::encode_bthd(&tq, a.q, a.B, a.Tq, a.H, D, a.q_sb, a.q_st, a.q_sh, BT);
  if (err == cudaSuccess)
    err = hopper::encode_bthd(&tk, a.k, a.B, a.Tk, a.H, D, a.k_sb, a.k_st, a.k_sh, BT);
  if (err == cudaSuccess)
    err = hopper::encode_bthd(&tv, a.v, a.B, a.Tk, a.H, D, a.v_sb, a.v_st, a.v_sh, BT);
  if (err == cudaSuccess)
    err = hopper::encode_bthd(&tg, a.g, a.B, a.Tq, a.H, D, a.g_sb, a.g_st, a.g_sh, BT);
  constexpr int smem = DkdvSmem<D>::TOTAL > DqSmem<D>::TOTAL ? DkdvSmem<D>::TOTAL
                                                              : DqSmem<D>::TOTAL;
  if (err == cudaSuccess) err = launch_delta<__nv_bfloat16, D>(a, stream);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;

  dim3 grid((a.Tk + BT - 1) / BT + (a.Tq + BT - 1) / BT, a.H, a.B);
  bwd_wgmma<D><<<grid, BwdWarps<D>::NWG * 128, smem, stream>>>(
      tq, tk, tv, tg, a.m, a.l, a.delta, a.lengths, static_cast<__nv_bfloat16*>(a.dq),
      static_cast<__nv_bfloat16*>(a.dk), static_cast<__nv_bfloat16*>(a.dv), a.H, a.Tq, a.Tk,
      a.scale, a.scale * LOG2E, a.causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (Q, K, V, O, dO and the outputs share
// it). Strides are in elements. `m`/`l` are the forward's fp32 [B,H,Tq] row
// statistics, `delta` an fp32 [B,H,Tq] scratch, `lengths` a device int32
// [B] or null; dQ/dK/dV are contiguous [B,T,H,D]. Launches the three
// kernels on `stream` and returns the first cudaError_t (0 on success); an
// unsupported D or dtype (both take D 16, 32, 64 and 128), or
// bf16 operands that TMA cannot read (base or strides not multiples of 16
// bytes), return cudaErrorInvalidValue.
extern "C" int flash_attn_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* m, const void* l, void* delta,
    const void* lengths, void* dq, void* dk, void* dv, int B, int H, int Tq,
    int Tk, int D, int dtype, long long q_sb, long long q_st, long long q_sh,
    long long k_sb, long long k_st, long long k_sh, long long v_sb,
    long long v_st, long long v_sh, long long o_sb, long long o_st,
    long long o_sh, long long g_sb, long long g_st, long long g_sh,
    float scale, int causal, void* stream) {
  const Args a{q, k, v, o, g,
               static_cast<const float*>(m), static_cast<const float*>(l),
               static_cast<float*>(delta), static_cast<const int*>(lengths),
               dq, dk, dv, B, H, Tq, Tk,
               q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
               o_sb, o_st, o_sh, g_sb, g_st, g_sh, scale, causal};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 128) return static_cast<int>(launch_fma<128>(a, s));
  if (dtype == 0 && D == 64) return static_cast<int>(launch_fma<64>(a, s));
  if (dtype == 0 && D == 32) return static_cast<int>(launch_fma<32>(a, s));
  if (dtype == 0 && D == 16) return static_cast<int>(launch_fma<16>(a, s));
  if (dtype == 1 && D == 128) return static_cast<int>(launch_wgmma<128>(a, s));
  if (dtype == 1 && D == 64) return static_cast<int>(launch_wgmma<64>(a, s));
  if (dtype == 1 && D == 32) return static_cast<int>(launch_wgmma<32>(a, s));
  if (dtype == 1 && D == 16) return static_cast<int>(launch_wgmma<16>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
