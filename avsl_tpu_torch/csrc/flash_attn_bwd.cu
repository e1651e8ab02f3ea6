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
// in fp32 and writes each result once, cast to the input type. Masking is
// the forward's: causal (k <= q) and key-length masks give the finite
// logit -1e30, so a row with key length 0 has m = -1e30, l = Tk and
// weights 1/Tk on every key, and its dS is formed at every key as the TPU
// kernel forms it; keys past Tk and q rows past Tq get weight 0.
//
// Design. The TPU kernel holds all of K/V in VMEM and carries dK/dV in
// fp32 across a sequential grid axis of q blocks. CUDA blocks run in
// parallel and in no order, so that carried sum becomes a loop inside one
// block, and the work splits into three launches with no atomics (the
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
// What bounds it: the five products are 10*B*H*Tq*Tk*D FLOP against
// Q, K, V, O, dO read and dQ, dK, dV written once; at the training
// encoder shape (B=1, H=20, T=500, D=64, bf16) that is 3.2e9 FLOP against
// 10 MB, far above the H100's ~295 FLOP/byte ridge, so it is bound by
// arithmetic. Like the forward, this first version runs its products on
// the fp32 FMA pipes from shared memory (4x4 register tiles, no
// mma/wgmma, no TMA), so its ceiling is the 67 TFLOP/s fp32 rate, not the
// 989 TFLOP/s bf16 tensor-core peak; it recomputes S once in each of (b)
// and (c). Moving the products onto wgmma is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
// rows), two more tiles of at most [64][RS] (row-major [64][D + PAD] tiles,
// and in (c) the [64][RS] dS tile), and three per-row vectors.
template <int D>
constexpr int bwd_smem_floats() {
  static_assert(D + PAD <= RS, "a row-major tile must fit a [64][RS] slot");
  return 4 * (D > BQ ? D : BQ) * RS + 2 * BQ * RS + 3 * BQ;
}

// (b) one block per (64-key tile, head, batch): dK and dV of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ g,
            const float* __restrict__ m_in, const float* __restrict__ l_in,
            const float* __restrict__ delta, const int* __restrict__ lengths,
            T* __restrict__ dk, T* __restrict__ dv, int H, int Tq, int Tk,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* gb = g + b * g_sb + h * g_sh;
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
      store_f(dk + off + j, acc_k[i][j]);
      store_f(dv + off + j, acc_v[i][j]);
    }
  }
}

// (c) one block per (64-row q tile, head, batch): dQ of the tile.
template <typename T, int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ g,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          const float* __restrict__ delta, const int* __restrict__ lengths,
          T* __restrict__ dq, int H, int Tq, int Tk, int64_t q_sb,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const T* gb = g + b * g_sb + h * g_sh;
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
    T* row = dq + ((int64_t(b) * Tq + qi) * H + h) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) store_f(row + j, acc[i][j]);
  }
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
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int64_t rows = int64_t(a.B) * a.H * a.Tq;
  const int64_t delta_blocks = (rows + NT / 32 - 1) / (NT / 32);
  delta_kernel<T, D><<<static_cast<unsigned>(delta_blocks), NT, 0, stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.delta, a.B,
      a.H, a.Tq, a.o_sb, a.o_st, a.o_sh, a.g_sb, a.g_st, a.g_sh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem = sizeof(float) * bwd_smem_floats<D>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;

  dim3 kgrid((a.Tk + BK - 1) / BK, a.H, a.B);
  dkdv_kernel<T, D><<<kgrid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.m, a.l,
      a.delta, a.lengths, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H,
      a.Tq, a.Tk, a.q_sb, a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb,
      a.v_st, a.v_sh, a.g_sb, a.g_st, a.g_sh, a.scale, a.causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 qgrid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  dq_kernel<T, D><<<qgrid, NT, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.m, a.l,
      a.delta, a.lengths, static_cast<T*>(a.dq), a.H, a.Tq, a.Tk, a.q_sb,
      a.q_st, a.q_sh, a.k_sb, a.k_st, a.k_sh, a.v_sb, a.v_st, a.v_sh, a.g_sb,
      a.g_st, a.g_sh, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (Q, K, V, O, dO and the outputs share
// it). Strides are in elements. `m`/`l` are the forward's fp32 [B,H,Tq] row
// statistics, `delta` an fp32 [B,H,Tq] scratch, `lengths` a device int32
// [B] or null; dQ/dK/dV are contiguous [B,T,H,D]. Launches the three
// kernels on `stream` and returns the first cudaError_t (0 on success); an
// unsupported D or dtype returns cudaErrorInvalidValue.
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
  if (dtype == 0 && D == 64) return static_cast<int>(launch<float, 64>(a, s));
  if (dtype == 0 && D == 32) return static_cast<int>(launch<float, 32>(a, s));
  if (dtype == 1 && D == 64) return static_cast<int>(launch<__nv_bfloat16, 64>(a, s));
  if (dtype == 1 && D == 32) return static_cast<int>(launch<__nv_bfloat16, 32>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
