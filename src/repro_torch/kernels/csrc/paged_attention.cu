// Paged decode attention for Hopper (sm_90a): one query token per request
// row, GQA over a block-indexed KV page pool.
//
// Replaces: src/repro/kernels/paged_attention.py::_decode_kernel (the
// Pallas TPU kernel behind paged_decode_attention).
//
// Computes, for every row b and query head h = n * G + g:
//   s_t   = (q[b, h] . k[page(b, t), t % ps, n]) * (1 / sqrt(Dk)),
//           NEG_INF for positions t >= length[b]
//   out   = sum_t softmax(s)_t * v[page(b, t), t % ps, n]
// with an online softmax (m, l, acc) in f32 over the row's page chain,
// written out as acc / max(l, 1e-37) in q's dtype. At length 0 every
// position is masked and the softmax weighs the whole table uniformly,
// exactly as the plain version does, so the walk then covers every page.
//
// Bound on this card: memory. A call must read the pages that hold valid
// positions, B * ceil(len / ps) * ps * N * (Dk + Dv) elements (2 bytes each
// in bf16), and does about 2 * B * Hq * len * (Dk + Dv) flops on them: a
// few flops per byte, far under the ~20 flops/byte where f32 FMA would take
// over from the 3.35 TB/s of HBM.
//
// Design (a first, simple one): one CTA per (row, kv head). The CTA reads
// its row's page ids itself (there is no scalar prefetch), stages one K
// page and one V page (ps x D, converted to f32) in shared memory, computes
// the G x ps scores with warp reductions, runs the online softmax for the G
// query heads of its kv head, and accumulates p @ V into an f32 accumulator
// in shared memory. Each K/V byte is read once. Each CTA walks its pages
// one after the other through four latency-bound phases (stage, scores,
// softmax, PV) with 4 warps, and only B * N CTAs exist: on the card this
// costs ~9 us per page whatever the page's bytes (PERF.md). Not yet done:
// split-K over pages so that a small batch fills more of the 132 SMs, and
// cp.async/TMA double buffering of the next page.
//
// Built without --use_fast_math: expf must stay exact enough for the 1e-5
// f32 contract against the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kThreads = 128;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

size_t smem_floats(int group, int d_k, int d_v, int page_size) {
  return (size_t)group * d_k            // q
         + (size_t)page_size * d_k      // K page
         + (size_t)page_size * d_v      // V page
         + (size_t)group * page_size    // scores, then p
         + (size_t)group * d_v          // acc
         + 3 * (size_t)group;           // m, l, correction
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ length, T* __restrict__ out,
                    int n_kv, int group, int d_k, int d_v, int page_size,
                    int pages_per_seq, float scale) {
  extern __shared__ float smem[];
  const int n = blockIdx.x % n_kv;  // kv head
  const int b = blockIdx.x / n_kv;  // request row
  const int hq = n_kv * group;
  float* q_s = smem;
  float* k_s = q_s + group * d_k;
  float* v_s = k_s + page_size * d_k;
  float* p_s = v_s + page_size * d_v;
  float* acc = p_s + group * page_size;
  float* m_s = acc + group * d_v;
  float* l_s = m_s + group;
  float* c_s = l_s + group;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  // the G query heads of kv head n are heads n*G .. n*G+G-1, contiguous
  const T* q_rows = q + ((int64_t)b * hq + (int64_t)n * group) * d_k;
  for (int i = tid; i < group * d_k; i += blockDim.x) q_s[i] = to_f32(q_rows[i]);
  for (int i = tid; i < group * d_v; i += blockDim.x) acc[i] = 0.f;
  for (int g = tid; g < group; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  const int len = length[b];
  int n_pages = len > 0 ? (len + page_size - 1) / page_size : pages_per_seq;
  if (n_pages > pages_per_seq) n_pages = pages_per_seq;
  const int64_t k_tok = (int64_t)n_kv * d_k;  // stride between tokens
  const int64_t v_tok = (int64_t)n_kv * d_v;

  for (int j = 0; j < n_pages; ++j) {
    const int64_t page = table[(int64_t)b * pages_per_seq + j];
    // the previous page's readers are done with k_s / v_s / p_s
    __syncthreads();
    const T* kp = k_pages + page * page_size * k_tok + (int64_t)n * d_k;
    for (int i = tid; i < page_size * d_k; i += blockDim.x) {
      const int t = i / d_k;
      k_s[i] = to_f32(kp[t * k_tok + (i - t * d_k)]);
    }
    const T* vp = v_pages + page * page_size * v_tok + (int64_t)n * d_v;
    for (int i = tid; i < page_size * d_v; i += blockDim.x) {
      const int t = i / d_v;
      v_s[i] = to_f32(vp[t * v_tok + (i - t * d_v)]);
    }
    __syncthreads();

    // scores: one warp per (g, t), lanes split the head dim
    for (int idx = warp; idx < group * page_size; idx += n_warps) {
      const int g = idx / page_size;
      const int t = idx - g * page_size;
      float dot = 0.f;
      for (int d = lane; d < d_k; d += 32) dot += q_s[g * d_k + d] * k_s[t * d_k + d];
      dot = warp_sum(dot);
      if (lane == 0)
        p_s[idx] = (j * page_size + t < len) ? dot * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head of the group
    for (int g = warp; g < group; g += n_warps) {
      float* row = p_s + g * page_size;
      float mx = kNegInf;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, row[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        const float p = expf(row[t] - m_new);
        row[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V; each thread owns fixed (g, d) entries
    for (int i = tid; i < group * d_v; i += blockDim.x) {
      const int g = i / d_v;
      const int d = i - g * d_v;
      const float* p = p_s + g * page_size;
      float a = 0.f;
      for (int t = 0; t < page_size; ++t) a += p[t] * v_s[t * d_v + d];
      acc[i] = acc[i] * c_s[g] + a;
    }
  }
  __syncthreads();

  T* o_rows = out + ((int64_t)b * hq + (int64_t)n * group) * d_v;
  for (int i = tid; i < group * d_v; i += blockDim.x)
    o_rows[i] = from_f32<T>(acc[i] / fmaxf(l_s[i / d_v], 1e-37f));
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* length, void* out, int batch,
           int n_kv, int group, int d_k, int d_v, int page_size,
           int pages_per_seq, float scale, cudaStream_t stream) {
  const size_t smem =
      smem_floats(group, d_k, d_v, page_size) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  paged_decode_kernel<T><<<batch * n_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int32_t*>(table),
      static_cast<const int32_t*>(length), static_cast<T*>(out), n_kv, group,
      d_k, d_v, page_size, pages_per_seq, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes (the wrapper refuses shapes whose
// staging does not fit the card's 227 KB).
size_t paged_decode_attention_smem_bytes(int group, int d_k, int d_v,
                                         int page_size) {
  return smem_floats(group, d_k, d_v, page_size) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16. Launches on `stream` without
// synchronising; returns cudaGetLastError() after the launch (0 = success).
int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* table,
                           const void* length, void* out, int batch, int n_kv,
                           int group, int d_k, int d_v, int page_size,
                           int pages_per_seq, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pages, v_pages, table, length, out, batch, n_kv,
                         group, d_k, d_v, page_size, pages_per_seq, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, table, length, out,
                                 batch, n_kv, group, d_k, d_v, page_size,
                                 pages_per_seq, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
