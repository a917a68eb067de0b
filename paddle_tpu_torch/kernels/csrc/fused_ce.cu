// Fused softmax cross-entropy for Hopper (sm_90a): forward (per-row loss
// and log-sum-exp in one streaming pass) and backward (one elementwise
// pass, the one-hot folded into the epilogue).
//
// Replaces the TPU kernels paddle_tpu/kernels/fused_ce.py:ce_fwd (bodies
// _fwd_kernel_whole / _fwd_kernel_grid) and :ce_bwd (_bwd_kernel_whole /
// _bwd_kernel_grid). lg is [N, V] f32 or bf16, row-major; labels [N]
// int32; columns at or past valid_vocab are masked out of the LSE and
// the backward, as there.
//
//   forward:  lse[n] = log(sum_{c < vv} exp(lg[n, c]))      (f32)
//             per[n] = lse[n] - lg[n, label[n]]
//   backward: dlg[n, c] = ((c < vv ? exp(lg[n, c] - lse[n]) : 0)
//                          - (c == label[n])) * g[n]          (at lg's type)
//
// What bounds it on this card: bytes. The forward reads the logits once
// (823 MB in bf16 at the GPT-125M training shape, N = 8192, V = 50304),
// the backward reads them once more and writes dlogits of the same size;
// the f32 arithmetic (one exp per element) sits well under that at the
// card's rate. So the design streams each row once with 16-byte vector
// loads and keeps everything else in registers:
//   - one block of 256 threads per row; each thread walks the row in
//     16-byte chunks and keeps its own running (max, sum-exp) pair, the
//     logsumexp monoid the TPU kernel carried across its vocab grid in
//     VMEM scratch; a warp-shuffle and then a shared-memory merge of the
//     32-way pairs takes the place of that sequential grid axis;
//   - the gold logit is one load by thread 0 (the TPU kernel's one-hot
//     compare, without the compare);
//   - the -inf/-inf guard of online_lse: a pair whose max is still -inf
//     (every column seen so far masked) weighs exactly 0 in a merge,
//     never exp(nan).
// The vector path needs V a multiple of the vector width (8 bf16 or 4
// f32) and a 16-byte-aligned base; otherwise the host picks the scalar
// instance.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

// Merge (m2, s2) into (m, s): the logsumexp monoid with the -inf guard.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  const float w1 = (m == -INFINITY) ? 0.f : expf(m - mn);
  const float w2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
  s = s * w1 + s2 * w2;
  m = mn;
}

// VEC elements of T starting at p (16-byte aligned when VEC > 1) into f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    x[0] = to_f32(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "16-byte vectors");
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) x[i] = to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&x)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f32<T>(x[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f32<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_fwd_kernel(const T* __restrict__ lg, const int* __restrict__ labels,
                  float* __restrict__ per, float* __restrict__ lse_out, int V,
                  int vv) {
  const long long row = blockIdx.x;
  const T* x = lg + row * (long long)V;
  float m = -INFINITY, s = 0.f;
  const int nvec = V / VEC;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[VEC];
    load_vec<T, VEC>(x + (long long)i * VEC, v);
    float mc = -INFINITY;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (i * VEC + j >= vv) v[j] = -INFINITY;
      mc = fmaxf(mc, v[j]);
    }
    if (mc == -INFINITY) continue;  // every column of the chunk masked
    const float mn = fmaxf(m, mc);
    float sc = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) sc += expf(v[j] - mn);  // exp(-inf) = 0
    s = ((m == -INFINITY) ? 0.f : s * expf(m - mn)) + sc;
    m = mn;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  __shared__ float sm[kWarps], ss[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < kWarps; ++w) lse_merge(m, s, sm[w], ss[w]);
    const float lse = logf(s) + m;  // every column masked: log 0 + -inf
    const int lab = labels[row];
    float gold = 0.f;               // a label outside [0, V) hits nothing
    if (lab >= 0 && lab < V) gold = lab < vv ? to_f32(x[lab]) : -INFINITY;
    per[row] = lse - gold;
    lse_out[row] = lse;
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    ce_bwd_kernel(const T* __restrict__ lg, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  T* __restrict__ dlg, int V, int vv) {
  const long long row = blockIdx.x;
  const T* x = lg + row * (long long)V;
  T* d = dlg + row * (long long)V;
  const float l = lse[row], gr = g[row];
  const int lab = labels[row];
  const int nvec = V / VEC;
  for (int i = threadIdx.x; i < nvec; i += kThreads) {
    float v[VEC];
    load_vec<T, VEC>(x + (long long)i * VEC, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = i * VEC + j;
      const float p = c < vv ? expf(v[j] - l) : 0.f;
      v[j] = (p - (c == lab ? 1.f : 0.f)) * gr;
    }
    store_vec<T, VEC>(d + (long long)i * VEC, v);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* lg, const int* labels, float* per,
                       float* lse, int N, int V, int vv, int vec,
                       cudaStream_t st) {
  const T* x = static_cast<const T*>(lg);
  if (vec > 1)
    ce_fwd_kernel<T, 16 / sizeof(T)><<<N, kThreads, 0, st>>>(x, labels, per,
                                                             lse, V, vv);
  else
    ce_fwd_kernel<T, 1><<<N, kThreads, 0, st>>>(x, labels, per, lse, V, vv);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* lg, const int* labels, const float* lse,
                       const float* g, void* dlg, int N, int V, int vv,
                       int vec, cudaStream_t st) {
  const T* x = static_cast<const T*>(lg);
  T* d = static_cast<T*>(dlg);
  if (vec > 1)
    ce_bwd_kernel<T, 16 / sizeof(T)><<<N, kThreads, 0, st>>>(
        x, labels, lse, g, d, V, vv);
  else
    ce_bwd_kernel<T, 1><<<N, kThreads, 0, st>>>(x, labels, lse, g, d, V, vv);
  return cudaGetLastError();
}

}  // namespace

// lg [N, V] contiguous, f32 (is_bf16 = 0) or bf16 (1); labels [N] int32;
// per, lse [N] f32 out. vec = 1 selects the scalar path, anything else the
// 16-byte path (the caller checks V % (16 / elem) == 0 and alignment).
// Returns the cudaError_t of the launch.
extern "C" int ce_fwd_launch(const void* lg, const void* labels, void* per,
                             void* lse, int N, int V, int vv, int is_bf16,
                             int vec, void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(per);
  float* l = static_cast<float*>(lse);
  return is_bf16 ? (int)launch_fwd<__nv_bfloat16>(lg, lab, p, l, N, V, vv,
                                                  vec, st)
                 : (int)launch_fwd<float>(lg, lab, p, l, N, V, vv, vec, st);
}

// lg, dlg [N, V] contiguous of one type; labels [N] int32; lse, g [N] f32.
extern "C" int ce_bwd_launch(const void* lg, const void* labels,
                             const void* lse, const void* g, void* dlg, int N,
                             int V, int vv, int is_bf16, int vec,
                             void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  return is_bf16 ? (int)launch_bwd<__nv_bfloat16>(lg, lab, l, gg, dlg, N, V,
                                                  vv, vec, st)
                 : (int)launch_bwd<float>(lg, lab, l, gg, dlg, N, V, vv, vec,
                                          st);
}
