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
// is bound by arithmetic. The design keeps the [Tq, Tk] score matrix out
// of device memory entirely (one pass over K/V per 64-row q tile, online
// softmax in registers, one division by the row sum at the end), so device
// memory traffic stays near the 123 MB floor. The products run on the
// fp32 FMA pipes from shared memory with a 4x4 register tile per thread;
// this first version does not use the tensor cores (no mma/wgmma, no TMA),
// so its ceiling is the fp32 FMA rate, not the 989 TFLOP/s bf16 peak.
// Moving QK^T and PV onto wgmma is the next step.
//
// Row statistics for the backward (csrc/flash_attn_bwd.cu): when the
// caller passes `m_out`/`l_out` (fp32 [B,H,Tq]), the kernel also writes
// each row's final max m and sum l of exp(x - m). They are kept apart, not
// folded into one log-sum-exp: on a row whose key length is 0 every logit
// is the finite -1e30, so m = -1e30 and l = Tk, and in fp32
// -1e30 + log(Tk) rounds back to -1e30, which would make the recomputed
// weights 1 instead of 1/Tk. With null pointers (serving) nothing else
// changes.
//
// Layout: Q [B,Tq,H,D], K/V [B,Tk,H,D] read through their batch/time/head
// strides (last dim contiguous), so no transpose copies; O is a
// contiguous [B,Tq,H,D] allocated by the caller. One block of 256 threads
// per (64-row q tile, head, batch). Templated on D in {32, 64} and on the
// element type in {float, __nv_bfloat16}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // q rows per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int NT = 256;      // threads per block: a 16 x 16 grid
constexpr int PAD = 4;       // smem row padding (keeps float4 alignment)
constexpr int RS = BQ + PAD; // row stride of the transposed Q/K and of P
constexpr float MASKED = -1.0e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Shared memory (floats): Qt [D][RS], Kt [D][RS], Vs [BK][D+PAD], Ps [BK][RS].
template <int D>
constexpr int smem_floats() {
  return 2 * D * RS + BK * (D + PAD) + BK * RS;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int len = lengths != nullptr ? lengths[b] : Tk;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qi = q0 + r;
    Qt[d * RS + r] = qi < Tq ? load_f(qb + qi * q_st + d) : 0.0f;
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
      Kt[d * RS + r] = in ? load_f(kb + ki * k_st + d) : 0.0f;
      Vs[r * VS + d] = in ? load_f(vb + ki * v_st + d) : 0.0f;
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
    T* orow = o + ((int64_t(b) * Tq + qi) * H + h) * D + tx * DC;
#pragma unroll
    for (int j = 0; j < DC; ++j) store_f(orow + j, acc[i][j] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const int* lengths, int B, int H, int Tq, int Tk,
                   int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                   int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                   int64_t v_sh, float scale, int causal, float* m_out,
                   float* l_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lengths, H, Tq, Tk, q_sb,
      q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, scale, causal, m_out,
      l_out);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. `lengths` is
// a device int32 [B] or null. `m_out`/`l_out` are device fp32 [B,H,Tq]
// for the row statistics, or both null. Returns the cudaError_t of the
// launch (0 on success); an unsupported D or dtype returns
// cudaErrorInvalidValue.
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, const void* lengths, int B, int H,
                              int Tq, int Tk, int D, int dtype, long long q_sb,
                              long long q_st, long long q_sh, long long k_sb,
                              long long k_st, long long k_sh, long long v_sb,
                              long long v_st, long long v_sh, float scale,
                              int causal, void* m_out, void* l_out,
                              void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  if ((m == nullptr) != (l == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define AVSL_LAUNCH(T, DD)                                                  \
  return static_cast<int>(launch<T, DD>(q, k, v, o, len, B, H, Tq, Tk, q_sb, \
                                        q_st, q_sh, k_sb, k_st, k_sh, v_sb,  \
                                        v_st, v_sh, scale, causal, m, l, s))
  if (dtype == 0 && D == 64) AVSL_LAUNCH(float, 64);
  if (dtype == 0 && D == 32) AVSL_LAUNCH(float, 32);
  if (dtype == 1 && D == 64) AVSL_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 32) AVSL_LAUNCH(__nv_bfloat16, 32);
#undef AVSL_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
