// The sLSTM cell for Hopper (sm_90a): one time step's gating and state
// update, forward and backward.
//
// No Pallas kernel stands behind it: the JAX package runs the sLSTM time
// step (src/repro/models/xlstm.py::_slstm_step) as plain jnp ops inside a
// lax.scan, which XLA fuses into one loop body. The port's step is this
// kernel beside the recurrent product, which stays torch.bmm (the JAX
// package's einsum, outside any kernel). models/xlstm.py::SLSTMScan runs the
// time loop: per step torch.bmm + slstm_cell_fwd forward, and
// slstm_cell_bwd + torch.bmm backward.
//
// Forward, per element (b, j) of B x d, j = head * dh + e, with the gate
// pre-activations p_g = gx[b, t, g * d + j] + f32(gr[head, b, g * dh + e]):
//   m'  = max(p_f + m, p_i)
//   fs  = exp(p_f + m - m'),  is = exp(p_i - m')
//   c'  = fs * c + is * tanh(p_z),  n' = fs * n + is
//   h   = sigmoid(p_o) * c' / max(n', 1e-6)
// written as the new state (c', n', m'), the step's h in h's dtype, and the
// four p_g (what the backward reads in place of the product it would
// otherwise recompute). Every product and sum is rounded on its own, as the
// plain version's unfused ops round them (explicit _rn intrinsics: nvcc
// would otherwise contract them into FMAs).
//
// Backward: the same step recomputed from p_g and the input state, then
// JAX's autodiff of _slstm_step term by term: the gradient flows through m,
// and jnp.maximum hands a tie half of the cotangent each way, in m' and in
// n''s 1e-6 floor. The step's h cotangent is the sum, in h's dtype, of the
// output's and of the next step's recurrent product's; the carries
// (dc, dn, dm) are updated in place; the gate cotangents are written in f32
// (gx's gradient) and in the recurrent weights' dtype (the product's
// cotangent, the operand of the next torch.bmm and of dR).
//
// Bound on this card: neither. A step moves ~0.5 MB at xlstm-1.3b's width
// and 4 rows (B x d = 8192 elements), a fraction of a microsecond of HBM;
// it is a launch. One thread an element, 256 a CTA.
//
// No --use_fast_math: expf, tanhf and IEEE division as the plain version's
// CUDA ops use them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float N_FLOOR = 1e-6f;
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rounds x to T and back: the value a tensor of dtype T holds.
template <typename T>
__device__ __forceinline__ float as(float x) { return to_f(from_f<T>(x)); }

struct Step {
  float gi, gf, gz, go, a, mn, fs, is, z, o, cn, nn, nd;
};

// The forward step from its pre-activations and input state, every
// operation rounded on its own.
__device__ __forceinline__ Step step(const float p[4], float c, float n,
                                     float m) {
  Step s;
  s.gi = p[0];
  s.gf = p[1];
  s.gz = p[2];
  s.go = p[3];
  s.a = __fadd_rn(s.gf, m);
  s.mn = fmaxf(s.a, s.gi);
  s.fs = expf(__fsub_rn(s.a, s.mn));
  s.is = expf(__fsub_rn(s.gi, s.mn));
  s.z = tanhf(s.gz);
  s.o = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-s.go)));
  s.cn = __fadd_rn(__fmul_rn(s.fs, c), __fmul_rn(s.is, s.z));
  s.nn = __fadd_rn(__fmul_rn(s.fs, n), s.is);
  s.nd = fmaxf(s.nn, N_FLOOR);
  return s;
}

// jnp.maximum(x, y)'s share of the cotangent that goes to x.
__device__ __forceinline__ float max_share(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

template <typename TR, typename TH>
__global__ void __launch_bounds__(THREADS)
slstm_fwd_kernel(const float* __restrict__ gx, int64_t gx_sb,
                 const TR* __restrict__ gr, const float* __restrict__ c,
                 const float* __restrict__ n, const float* __restrict__ m,
                 float* __restrict__ c_out, float* __restrict__ n_out,
                 float* __restrict__ m_out, float* __restrict__ pre,
                 int64_t pre_sb, TH* __restrict__ h, int64_t h_sb, int B,
                 int nh, int dh) {
  const int d = nh * dh;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (int64_t)B * d) return;
  const int b = (int)(idx / d), j = (int)(idx % d);
  const int head = j / dh, e = j % dh;
  const TR* grb = gr + ((int64_t)head * B + b) * 4 * dh + e;
  const float* gxb = gx + b * gx_sb + j;
  float p[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) p[g] = __fadd_rn(gxb[g * d], to_f(grb[g * dh]));
  if (pre != nullptr) {
    float* pb = pre + b * pre_sb + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) pb[g * d] = p[g];
  }
  const Step s = step(p, c[idx], n[idx], m[idx]);
  c_out[idx] = s.cn;
  n_out[idx] = s.nn;
  m_out[idx] = s.mn;
  h[b * h_sb + j] = from_f<TH>(__fdiv_rn(__fmul_rn(s.o, s.cn), s.nd));
}

template <typename TR, typename TH>
__global__ void __launch_bounds__(THREADS)
slstm_bwd_kernel(const float* __restrict__ pre, int64_t pre_sb,
                 const float* __restrict__ c, const float* __restrict__ n,
                 const float* __restrict__ m, const TH* __restrict__ dh_out,
                 int64_t dh_sb, const TR* __restrict__ dhr,
                 float* __restrict__ dc, float* __restrict__ dn,
                 float* __restrict__ dm, float* __restrict__ dpre,
                 int64_t dpre_sb, TR* __restrict__ dgr, int64_t dgr_sh,
                 int B, int nh, int dh) {
  const int d = nh * dh;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (int64_t)B * d) return;
  const int b = (int)(idx / d), j = (int)(idx % d);
  const int head = j / dh, e = j % dh;
  float p[4];
  const float* pb = pre + b * pre_sb + j;
#pragma unroll
  for (int g = 0; g < 4; ++g) p[g] = pb[g * d];
  const float cp = c[idx], np = n[idx];
  const Step s = step(p, cp, np, m[idx]);

  // h's cotangent: the output's plus the next step's product's, in h's
  // dtype (the product's arrives in the weights' dtype and is cast first)
  float g_out = dh_out != nullptr ? to_f(dh_out[b * dh_sb + j]) : 0.0f;
  float g_rec = dhr != nullptr
      ? as<TH>(to_f(dhr[((int64_t)head * B + b) * dh + e])) : 0.0f;
  const float g_h = as<TH>(__fadd_rn(g_out, g_rec));

  // h = (o * c') / nd
  const float q = __fmul_rn(s.o, s.cn);
  const float dq = __fdiv_rn(g_h, s.nd);
  const float dnd = __fdiv_rn(__fmul_rn(-g_h, q), __fmul_rn(s.nd, s.nd));
  const float d_o = __fmul_rn(dq, s.cn);
  const float dcn = __fadd_rn(dc[idx], __fmul_rn(dq, s.o));
  const float dnn = __fadd_rn(dn[idx],
                              __fmul_rn(dnd, max_share(s.nn, N_FLOOR)));
  // c' = fs * c + is * z,  n' = fs * n + is
  const float dfs = __fadd_rn(__fmul_rn(dcn, cp), __fmul_rn(dnn, np));
  const float dis = __fadd_rn(__fmul_rn(dcn, s.z), dnn);
  const float dz = __fmul_rn(dcn, s.is);
  // z = tanh(p_z), o = sigmoid(p_o)
  const float dgz = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(s.z, s.z)));
  const float dgo = __fmul_rn(d_o, __fmul_rn(s.o, __fsub_rn(1.0f, s.o)));
  // fs = exp(p_f + m - m'), is = exp(p_i - m')
  const float tf = __fmul_rn(dfs, s.fs);
  const float ti = __fmul_rn(dis, s.is);
  const float dmn = __fsub_rn(__fsub_rn(dm[idx], tf), ti);
  // m' = max(p_f + m, p_i)
  const float w = max_share(s.a, s.gi);
  const float da = __fadd_rn(tf, __fmul_rn(dmn, w));
  const float dgi = __fadd_rn(ti, __fmul_rn(dmn, __fsub_rn(1.0f, w)));

  dc[idx] = __fmul_rn(dcn, s.fs);
  dn[idx] = __fmul_rn(dnn, s.fs);
  dm[idx] = da;
  const float dp[4] = {dgi, da, dgz, dgo};
  float* db = dpre + b * dpre_sb + j;
  TR* gb = dgr + head * dgr_sh + (int64_t)b * 4 * dh + e;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    db[g * d] = dp[g];
    gb[g * dh] = from_f<TR>(dp[g]);
  }
}

template <typename TR, typename TH>
int fwd(const void* gx, int64_t gx_sb, const void* gr, const void* c,
        const void* n, const void* m, void* c_out, void* n_out, void* m_out,
        void* pre, int64_t pre_sb, void* h, int64_t h_sb, int B, int nh,
        int dh, cudaStream_t stream) {
  const int64_t total = (int64_t)B * nh * dh;
  const int grid = (int)((total + THREADS - 1) / THREADS);
  slstm_fwd_kernel<TR, TH><<<grid, THREADS, 0, stream>>>(
      (const float*)gx, gx_sb, (const TR*)gr, (const float*)c,
      (const float*)n, (const float*)m, (float*)c_out, (float*)n_out,
      (float*)m_out, (float*)pre, pre_sb, (TH*)h, h_sb, B, nh, dh);
  return (int)cudaGetLastError();
}

template <typename TR, typename TH>
int bwd(const void* pre, int64_t pre_sb, const void* c, const void* n,
        const void* m, const void* dh_out, int64_t dh_sb, const void* dhr,
        void* dc, void* dn, void* dm, void* dpre, int64_t dpre_sb, void* dgr,
        int64_t dgr_sh, int B, int nh, int dh, cudaStream_t stream) {
  const int64_t total = (int64_t)B * nh * dh;
  const int grid = (int)((total + THREADS - 1) / THREADS);
  slstm_bwd_kernel<TR, TH><<<grid, THREADS, 0, stream>>>(
      (const float*)pre, pre_sb, (const float*)c, (const float*)n,
      (const float*)m, (const TH*)dh_out, dh_sb, (const TR*)dhr, (float*)dc,
      (float*)dn, (float*)dm, (float*)dpre, dpre_sb, (TR*)dgr, dgr_sh, B, nh,
      dh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r_bf16 / h_bf16: 1 if the recurrent weights / h are bfloat16, 0 if
// float32. Strides are in elements: *_sb between rows b, dgr_sh between
// heads. pre may be null (no backward to feed). Returns a cudaError_t.
int slstm_cell_fwd(const void* gx, int64_t gx_sb, const void* gr,
                   const void* c, const void* n, const void* m, void* c_out,
                   void* n_out, void* m_out, void* pre, int64_t pre_sb,
                   void* h, int64_t h_sb, int B, int nh, int dh, int r_bf16,
                   int h_bf16, cudaStream_t stream) {
#define SLSTM_FWD(TR, TH)                                                   \
  return fwd<TR, TH>(gx, gx_sb, gr, c, n, m, c_out, n_out, m_out, pre,      \
                     pre_sb, h, h_sb, B, nh, dh, stream)
  if (r_bf16 && h_bf16) SLSTM_FWD(__nv_bfloat16, __nv_bfloat16);
  if (r_bf16) SLSTM_FWD(__nv_bfloat16, float);
  if (h_bf16) SLSTM_FWD(float, __nv_bfloat16);
  SLSTM_FWD(float, float);
#undef SLSTM_FWD
}

// dh_out and dhr may be null (a zero cotangent).
int slstm_cell_bwd(const void* pre, int64_t pre_sb, const void* c,
                   const void* n, const void* m, const void* dh_out,
                   int64_t dh_sb, const void* dhr, void* dc, void* dn,
                   void* dm, void* dpre, int64_t dpre_sb, void* dgr,
                   int64_t dgr_sh, int B, int nh, int dh, int r_bf16,
                   int h_bf16, cudaStream_t stream) {
#define SLSTM_BWD(TR, TH)                                                   \
  return bwd<TR, TH>(pre, pre_sb, c, n, m, dh_out, dh_sb, dhr, dc, dn, dm,  \
                     dpre, dpre_sb, dgr, dgr_sh, B, nh, dh, stream)
  if (r_bf16 && h_bf16) SLSTM_BWD(__nv_bfloat16, __nv_bfloat16);
  if (r_bf16) SLSTM_BWD(__nv_bfloat16, float);
  if (h_bf16) SLSTM_BWD(float, __nv_bfloat16);
  SLSTM_BWD(float, float);
#undef SLSTM_BWD
}

}  // extern "C"
