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
// Bound on this card: bytes. A call must read the pages that hold valid
// positions, B * ceil(len / ps) * ps * N * (Dk + Dv) elements (2 bytes each
// in bf16), and does about 2 * B * Hq * len * (Dk + Dv) flops on them: a
// few flops per byte, far under the ~20 flops/byte where f32 FMA would take
// over from the 3.35 TB/s of HBM. So the design keeps as many page bytes
// in flight as the card can take, and little else on the way:
//
//   * Split-K over the page table. CTA (b, s) takes the contiguous page
//     range [s * per, (s + 1) * per) of row b for all N kv heads, so that a
//     page's K and V are each one contiguous run. The split count comes from
//     shapes alone (kernels/paged_attention.py::split_plan: the table width,
//     the page size, B and N), never from length, which lives on the card:
//     the call needs no host sync and stays capturable in a CUDA graph. At
//     B = 8 and a 256-page table that is 32 splits of 8 pages, 256 CTAs for
//     132 SMs (one CTA per (row, kv head) would be 24).
//   * Copies in flight. A CTA loads its split's page ids once, then keeps
//     NBUF - 1 rounds of R pages in flight with cp.async (16 bytes a thread,
//     a plain linear walk of each page's run: no per-element division), K
//     and V in their own dtype in shared memory, widened in registers. One
//     barrier per round of R pages: it makes the round's copies visible and
//     frees the buffer the next copy overwrites. Everything else a round
//     touches is private to one warp.
//   * One warp per query head: lanes over the round's tokens for the scores
//     (each lane starts its dot product at its own 16-byte chunk, so the
//     lanes of a shared-memory phase hit distinct banks), warp shuffles for
//     the max and the sum, then lanes over column pairs of V for p . V into
//     the head's f32 accumulator. No tensor cores: G = 3 query rows per kv
//     head are far below an MMA tile, and the bound is bytes.
//   * A split wholly past a nonzero length reads no page and writes
//     (m, l, acc) = (NEG_INF, 0, 0). paged_combine_kernel merges a row's
//     splits in split order, weight exp(m_s - M) with M = max_s m_s (exact
//     1 at length 0, where every m_s = M = NEG_INF; 0 for an empty split),
//     so a run's bits never change. With one split the CTA writes the
//     output itself and the combine is not launched.
//
// Built without --use_fast_math: expf must stay exact enough for the 1e-5
// f32 contract against the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kMinWarps = 4;               // warps that issue the copies
constexpr int kMaxWarps = 16;
constexpr int kRoundTokens = 32;           // a round: at most a lane a token
constexpr size_t kSmemLimit = 232448;      // H100: 227 KB per CTA
constexpr size_t kSmemTwoCtas = 113 * 1024;  // two CTAs on one SM
constexpr int kCombineThreads = 64;

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

// 16 bytes of T from shared memory, widened to f32 (bf16 -> f32 is exact:
// the bf16 bits are the f32's upper half).
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Two neighbouring elements of T from shared memory, as f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr size_t pad16(size_t bytes) {
  return (bytes + 15) & ~(size_t)15;
}

// Shared memory of one CTA, byte offsets: nbuf round buffers of R pages
// (K of the round's tokens [R*ps][N][Dk], then V [R*ps][N][Dv], in T),
// q [Hq][Dk], acc [Hq][Dv], p [Hq][R*ps], m and l [Hq] in f32, the split's
// page ids.
struct Layout {
  int rp, nbuf;               // pages per round, round buffers
  size_t k_round, buf;        // bytes of a round's K, of a round buffer
  size_t q, acc, p, m, l, ids, total;
  int p_stride;               // floats per head in p
};

__host__ __device__ inline Layout layout(int rp, int nbuf, int n_kv,
                                         int group, int d_k, int d_v,
                                         int page_size, int elem, int per) {
  Layout L;
  const int hq = n_kv * group;
  L.rp = rp;
  L.nbuf = nbuf;
  L.k_round = (size_t)rp * page_size * n_kv * d_k * elem;
  L.buf = L.k_round + (size_t)rp * page_size * n_kv * d_v * elem;
  L.p_stride = (rp * page_size + 3) & ~3;
  L.q = (size_t)nbuf * L.buf;
  L.acc = L.q + pad16((size_t)hq * d_k * 4);
  L.p = L.acc + pad16((size_t)hq * d_v * 4);
  L.m = L.p + pad16((size_t)hq * L.p_stride * 4);
  L.l = L.m + pad16((size_t)hq * 4);
  L.ids = L.l + pad16((size_t)hq * 4);
  L.total = L.ids + pad16((size_t)per * 4);
  return L;
}

// The staging a shape gets: the first layout that fits two CTAs on an SM,
// else one CTA's 227 KB, trying rounds of up to kRoundTokens tokens (then
// half as many pages, down to one) and for each as many round buffers as
// the split's rounds can use (4 down to 2). Its total exceeds kSmemLimit
// only when two buffers of one page do not fit.
inline Layout plan(int n_kv, int group, int d_k, int d_v, int page_size,
                   int elem, int per) {
  int rp = page_size >= kRoundTokens ? 1 : kRoundTokens / page_size;
  if (rp > per) rp = per;
  const size_t caps[2] = {kSmemTwoCtas, kSmemLimit};
  for (const size_t cap : caps) {
    for (int r = rp; r >= 1; r = r > 1 ? (r + 1) / 2 : 0) {
      const int rounds = (per + r - 1) / r;
      int nb = rounds + 1 < 4 ? rounds + 1 : 4;
      if (nb < 2) nb = 2;
      for (; nb >= 2; --nb) {
        const Layout L = layout(r, nb, n_kv, group, d_k, d_v, page_size,
                                elem, per);
        if (L.total <= cap) return L;
      }
    }
  }
  return layout(1, 2, n_kv, group, d_k, d_v, page_size, elem, per);
}

template <typename T>
struct Args {
  const T* q;
  const T* k_pages;
  const T* v_pages;
  const int32_t* table;
  const int32_t* length;
  T* out;
  float* part;      // (B, splits, Hq, 2 + Dv) f32: m, l per head, then acc
  int n_kv, group, d_k, d_v, page_size, width, n_splits, per;
  float scale;
};

// Pages [j0, j0 + np) of the split (ids in shared memory) into a round
// buffer, 16 bytes a thread; the caller commits the group.
template <typename T>
__device__ __forceinline__ void issue_round(const Args<T>& a, const Layout& L,
                                            unsigned char* buf,
                                            const int* ids, int j0, int np) {
  const size_t k_page = (size_t)a.page_size * a.n_kv * a.d_k * sizeof(T);
  const size_t v_page = (size_t)a.page_size * a.n_kv * a.d_v * sizeof(T);
  const int k_chunks = (int)(k_page / 16), v_chunks = (int)(v_page / 16);
  for (int j = 0; j < np; ++j) {
    const int64_t page = ids[j0 + j];
    const unsigned char* ks =
        reinterpret_cast<const unsigned char*>(a.k_pages) + page * k_page;
    const unsigned char* vs =
        reinterpret_cast<const unsigned char*>(a.v_pages) + page * v_page;
    unsigned char* kd = buf + j * k_page;
    unsigned char* vd = buf + L.k_round + j * v_page;
#pragma unroll 4
    for (int c = threadIdx.x; c < k_chunks; c += blockDim.x)
      cp_async16(kd + (size_t)c * 16, ks + (size_t)c * 16);
#pragma unroll 4
    for (int c = threadIdx.x; c < v_chunks; c += blockDim.x)
      cp_async16(vd + (size_t)c * 16, vs + (size_t)c * 16);
  }
}

// One round (tokens of the buffer, the first at position pos0) for the
// warp's query heads: scores, online softmax, acc = acc * corr + p . V.
template <typename T>
__device__ __forceinline__ void consume(const Args<T>& a, const Layout& L,
                                        const unsigned char* buf, int tokens,
                                        int pos0, int len, float* q_s,
                                        float* acc_s, float* p_s, float* m_s,
                                        float* l_s, int c_rot) {
  constexpr int kVec = Vec16<T>::n;
  const int lane = threadIdx.x & 31;
  const int hq = a.n_kv * a.group;
  const int n_chunks = a.d_k / kVec;
  const T* kb = reinterpret_cast<const T*>(buf);
  const T* vb = reinterpret_cast<const T*>(buf + L.k_round);
  const size_t k_tok = (size_t)a.n_kv * a.d_k;   // elements between tokens
  const size_t v_tok = (size_t)a.n_kv * a.d_v;
  for (int h = threadIdx.x >> 5; h < hq; h += blockDim.x >> 5) {
    const int n = h / a.group;
    const float* qh = q_s + (size_t)h * a.d_k;
    float* ph = p_s + (size_t)h * L.p_stride;
    const float m_old = m_s[h];
    float mx = kNegInf;
    for (int t = lane; t < tokens; t += 32) {
      const T* kr = kb + t * k_tok + (size_t)n * a.d_k;
      float dot = 0.f;
      int c = c_rot;
      for (int i = 0; i < n_chunks; ++i) {
        float kv[kVec];
        Vec16<T>::load(kr + c * kVec, kv);
        const float4* qc = reinterpret_cast<const float4*>(qh + c * kVec);
#pragma unroll
        for (int e = 0; e < kVec / 4; ++e) {
          const float4 qv = qc[e];
          dot = fmaf(qv.x, kv[4 * e], dot);
          dot = fmaf(qv.y, kv[4 * e + 1], dot);
          dot = fmaf(qv.z, kv[4 * e + 2], dot);
          dot = fmaf(qv.w, kv[4 * e + 3], dot);
        }
        if (++c == n_chunks) c = 0;
      }
      const float s = pos0 + t < len ? dot * a.scale : kNegInf;
      ph[t] = s;
      mx = fmaxf(mx, s);
    }
    const float m_new = fmaxf(m_old, warp_max(mx));
    float sum = 0.f;
    for (int t = lane; t < tokens; t += 32) {
      const float p = expf(ph[t] - m_new);
      ph[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    const float corr = expf(m_old - m_new);
    __syncwarp();   // every lane's p is written
    const T* vh = vb + (size_t)n * a.d_v;
    float* ah = acc_s + (size_t)h * a.d_v;
    for (int d = 2 * lane; d < a.d_v; d += 64) {
      float a0 = 0.f, a1 = 0.f;
      for (int t = 0; t < tokens; ++t) {
        const float p = ph[t];
        const float2 v = load2(vh + t * v_tok + d);
        a0 = fmaf(p, v.x, a0);
        a1 = fmaf(p, v.y, a1);
      }
      ah[d] = fmaf(ah[d], corr, a0);
      ah[d + 1] = fmaf(ah[d + 1], corr, a1);
    }
    __syncwarp();   // every lane has read this head's m, l and p
    if (lane == 0) {
      l_s[h] = fmaf(l_s[h], corr, sum);
      m_s[h] = m_new;
    }
  }
}

template <typename T, int NBUF>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_kernel(const Args<T> a, const Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* m_s = reinterpret_cast<float*>(smem + L.m);
  float* l_s = reinterpret_cast<float*>(smem + L.l);
  int* ids = reinterpret_cast<int*>(smem + L.ids);
  const int tid = threadIdx.x, lane = tid & 31, nt = blockDim.x;
  const int b = blockIdx.x / a.n_splits;   // request row
  const int s = blockIdx.x - b * a.n_splits;  // split of the row
  const int hq = a.n_kv * a.group;
  const int first = s * a.per;

  // length, q and the ids of the split's range are independent loads
  const int len = a.length[b];
  const T* qb = a.q + (size_t)b * hq * a.d_k;
  for (int i = tid; i < hq * a.d_k; i += nt) q_s[i] = to_f32(qb[i]);
  const int32_t* tb = a.table + (size_t)b * a.width + first;
  const int in_table = min(a.per, a.width - first);
  for (int i = tid; i < in_table; i += nt) ids[i] = tb[i];
  for (int i = tid; i < hq * a.d_v; i += nt) acc_s[i] = 0.f;
  for (int i = tid; i < hq; i += nt) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  int n_pages = len > 0 ? (len + a.page_size - 1) / a.page_size : a.width;
  if (n_pages > a.width) n_pages = a.width;
  const int count = min(a.per, n_pages - first);   // pages this split reads
  if (count <= 0) {   // wholly past the length: weight 0 in the combine
    float* part = a.part + ((size_t)b * a.n_splits + s) * hq * (2 + a.d_v);
    for (int i = tid; i < hq * (2 + a.d_v); i += nt)
      part[i] = i < 2 * hq && !(i & 1) ? kNegInf : 0.f;
    return;
  }
  __syncthreads();

  const int rounds = (count + L.rp - 1) / L.rp;
  const int c_rot = lane % (a.d_k / Vec16<T>::n);
#pragma unroll
  for (int r = 0; r < NBUF - 1; ++r) {
    if (r < rounds)
      issue_round(a, L, smem + r * L.buf, ids, r * L.rp,
                  min(L.rp, count - r * L.rp));
    cp_async_commit();
  }
  for (int r = 0; r < rounds; ++r) {
    cp_async_wait<NBUF - 2>();   // round r has landed (this thread's part)
    // round r is visible to all; every warp is done with round r - 1,
    // whose buffer the next copy overwrites
    __syncthreads();
    const int nr = r + NBUF - 1;
    if (nr < rounds)
      issue_round(a, L, smem + (nr % NBUF) * L.buf, ids, nr * L.rp,
                  min(L.rp, count - nr * L.rp));
    cp_async_commit();
    const int np = min(L.rp, count - r * L.rp);
    consume(a, L, smem + (r % NBUF) * L.buf, np * a.page_size,
            (first + r * L.rp) * a.page_size, len, q_s, acc_s, p_s, m_s, l_s,
            c_rot);
  }
  cp_async_wait<0>();

  // each warp's heads are its own: no block barrier before the epilogue
  __syncwarp();
  for (int h = tid >> 5; h < hq; h += nt >> 5) {
    const float* ah = acc_s + (size_t)h * a.d_v;
    if (a.n_splits == 1) {
      const float l = fmaxf(l_s[h], 1e-37f);
      T* o = a.out + ((size_t)b * hq + h) * a.d_v;
      for (int d = lane; d < a.d_v; d += 32) o[d] = from_f32<T>(ah[d] / l);
    } else {
      float* part = a.part + ((size_t)b * a.n_splits + s) * hq * (2 + a.d_v);
      if (lane == 0) {
        part[2 * h] = m_s[h];
        part[2 * h + 1] = l_s[h];
      }
      float* pa = part + 2 * hq + (size_t)h * a.d_v;
      for (int d = lane; d < a.d_v; d += 32) pa[d] = ah[d];
    }
  }
}

// out[b, h] = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-37) with
// w_s = exp(m_s - max_s m_s), the splits taken in order: one CTA per
// (query head, row). The splits' (m, l) and weights are loaded and
// computed once, side by side, into shared memory; threads over Dv then
// read the splits' accumulators with up to 32 loads in flight.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int hq, int d_v, int n_splits) {
  extern __shared__ float w_s[];         // [n_splits] m, then the weight
  float* l_s = w_s + n_splits;           // [n_splits]
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t stride = (size_t)hq * (2 + d_v);
  const float* pb = part + (size_t)b * n_splits * stride;
  for (int s = tid; s < n_splits; s += blockDim.x) {
    w_s[s] = pb[s * stride + 2 * h];
    l_s[s] = pb[s * stride + 2 * h + 1];
  }
  __syncthreads();
  float mx = kNegInf;
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, w_s[s]);
  __syncthreads();   // every thread has read the m's
  for (int s = tid; s < n_splits; s += blockDim.x) w_s[s] = expf(w_s[s] - mx);
  __syncthreads();
  float l = 0.f;
  for (int s = 0; s < n_splits; ++s) l = fmaf(w_s[s], l_s[s], l);
  l = fmaxf(l, 1e-37f);
  const float* pa = pb + 2 * hq + (size_t)h * d_v;
  for (int d = tid; d < d_v; d += blockDim.x) {
    float acc = 0.f;
#pragma unroll 32
    for (int s = 0; s < n_splits; ++s)
      acc = fmaf(w_s[s], pa[s * stride + d], acc);
    out[((size_t)b * hq + h) * d_v + d] = from_f32<T>(acc / l);
  }
}

template <typename T, int NBUF>
int launch_split(const Args<T>& a, const Layout& L, int batch,
                 cudaStream_t stream) {
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, NBUF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (e != cudaSuccess) return (int)e;
  }
  int warps = a.n_kv * a.group;
  warps = warps < kMinWarps ? kMinWarps : warps > kMaxWarps ? kMaxWarps : warps;
  paged_decode_kernel<T, NBUF>
      <<<batch * a.n_splits, warps * 32, L.total, stream>>>(a, L);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args<T>& a, int batch, cudaStream_t stream) {
  const Layout L = plan(a.n_kv, a.group, a.d_k, a.d_v, a.page_size,
                        (int)sizeof(T), a.per);
  if (L.total > kSmemLimit || batch < 1 || batch > 65535 ||
      (long long)batch * a.n_splits > 0x7fffffffLL ||
      (a.n_splits > 1 && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  int err = L.nbuf == 4   ? launch_split<T, 4>(a, L, batch, stream)
            : L.nbuf == 3 ? launch_split<T, 3>(a, L, batch, stream)
                          : launch_split<T, 2>(a, L, batch, stream);
  if (err != 0 || a.n_splits == 1) return err;
  paged_combine_kernel<T>
      <<<dim3(a.n_kv * a.group, batch), kCombineThreads,
          2 * a.n_splits * sizeof(float), stream>>>(
          a.part, a.out, a.n_kv * a.group, a.d_v, a.n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one CTA needs, in bytes, for elements of elem bytes and
// splits of per pages (the wrapper refuses shapes above the card's 227 KB:
// those where two pages of all kv heads do not fit).
size_t paged_decode_attention_smem_bytes(int n_kv, int group, int d_k,
                                         int d_v, int page_size, int elem,
                                         int per) {
  return plan(n_kv, group, d_k, d_v, page_size, elem, per).total;
}

// dtype: 0 = float32, 1 = bfloat16. part: n_splits > 1 only, (batch,
// n_splits, Hq, 2 + d_v) f32 scratch. Launches the split kernel (and, for
// more than one split, the combine) on `stream` without synchronising;
// returns cudaGetLastError() after the launches (0 = success).
int paged_decode_attention(int dtype, const void* q, const void* k_pages,
                           const void* v_pages, const void* table,
                           const void* length, void* out, void* part,
                           int batch, int n_kv, int group, int d_k, int d_v,
                           int page_size, int width, int n_splits, int per,
                           float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(
        Args<float>{static_cast<const float*>(q),
                    static_cast<const float*>(k_pages),
                    static_cast<const float*>(v_pages),
                    static_cast<const int32_t*>(table),
                    static_cast<const int32_t*>(length),
                    static_cast<float*>(out), static_cast<float*>(part), n_kv,
                    group, d_k, d_v, page_size, width, n_splits, per, scale},
        batch, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        Args<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(q),
                            static_cast<const __nv_bfloat16*>(k_pages),
                            static_cast<const __nv_bfloat16*>(v_pages),
                            static_cast<const int32_t*>(table),
                            static_cast<const int32_t*>(length),
                            static_cast<__nv_bfloat16*>(out),
                            static_cast<float*>(part), n_kv, group, d_k, d_v,
                            page_size, width, n_splits, per, scale},
        batch, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
