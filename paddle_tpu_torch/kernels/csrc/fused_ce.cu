// Fused softmax cross-entropy for Hopper (sm_90a): forward (per-row loss
// and log-sum-exp in one streaming pass) and backward (one elementwise
// pass, the one-hot folded into the epilogue, dlogits at a type of the
// caller's choice).
//
// Replaces the TPU kernels paddle_tpu/kernels/fused_ce.py:ce_fwd (bodies
// _fwd_kernel_whole / _fwd_kernel_grid) and :ce_bwd (_bwd_kernel_whole /
// _bwd_kernel_grid). lg is [N, V] f32 or bf16, row-major; labels [N]
// int32; columns at or past valid_vocab (vv) are masked out of the LSE
// and the backward, as there.
//
//   forward:  lse[n] = log(sum_{c < vv} exp(lg[n, c]))      (f32)
//             per[n] = lse[n] - lg[n, label[n]]
//   backward: dlg[n, c] = ((c < vv ? exp(lg[n, c] - lse[n]) : 0)
//                          - (c == label[n])) * g[n]   (f32, then rounded
//                          to dlg's type as __float2bfloat16 rounds: RNE)
//
// What bounds it on this card: bytes. The forward reads the logits once
// (824 MB in bf16 at the GPT-125M training shape, N = 8192, V = 50304),
// the backward reads them once more and writes dlogits; the f32
// arithmetic (one exp per element, 16 a clock on an SM's MUFU) needs
// under half the bytes' time. So the design keeps enough 16-byte loads in
// flight at every shape the port runs:
//   - Every row takes 16-byte vectors, whatever V and the base offset:
//     a row splits into a head of up to 7 bf16 / 3 f32 elements (up to
//     its first 16-byte boundary), a body of 16-byte vectors and a tail;
//     each row computes its own split (row starts drift in alignment when
//     V is no multiple of the vector width). A few lanes load the head
//     and the tail as scalars. The backward splits by the narrower of
//     its two types (a unit of 8 elements when one side is bf16) and the
//     wrapper gives dlogits the input's offset, so both sides of a unit
//     are 16-byte aligned.
//   - Loads kept in flight: each thread starts kUnroll = 4 independent
//     16-byte body loads before it uses any of them; a block of 256
//     threads (forward) or 512 (backward) walks one row. The other design
//     that was built and timed beside it, a 4-stage ring of 8 KB
//     shared-memory tiles fed by 1-D bulk copies (cp.async.bulk, mbarrier
//     complete_tx) from one thread, lost and is not kept. Timed in turns
//     on an NVIDIA H100 80GB HBM3 (700 W), registers / ring in ms:
//     GPT-125M bf16 (8192 x 50304) fwd 0.2782 / 0.2788, bwd 0.5651 /
//     0.5700; V 30522 at N 4096 bf16 0.1021 / 0.1013 and 0.1800 / 0.1828,
//     f32 0.1779 / 0.1815 and 0.3588 / 0.3588; at N 256 the ring is 4-10 %
//     slower (bf16 fwd 0.0164 / 0.0181). Within 2 % where the bytes are
//     large, ahead where they are few, and with no shared memory or
//     barriers: registers won. More per thread (8 loads, 512-thread
//     forward blocks, 8 blocks an SM forced by launch bounds) measured
//     slower in the forward.
//   - One block a row at every N. Splitting a short batch's rows over a
//     thread-block cluster (pairs merged in distributed shared memory)
//     was timed too: it cost the forward at N 256 (0.0162 ms at one
//     block a row, 0.0214 at four) and saved about 2 us a launch only at
//     N <= 64, where only chip_smoke.py's f32 oracle (batch 1 x 64 at
//     V 32000) runs a large vocabulary, so it is not kept.
//   - The forward's running sums use exp2 of one FMA (x log2e - m log2e;
//     the shared m log2e moves every term by one factor within 2^-20 of
//     1, far inside the LSE's 1e-6 limit); the backward keeps expf, as
//     its dlogits are held element by element to 1e-6 of each.
//   - The -inf/-inf guard of online_lse: a pair whose max is still -inf
//     weighs exactly 0 in a merge, never exp(nan). Columns at or past vv
//     are not read by the forward at all.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kFwdThreads = 256;  // a block of the forward
constexpr int kBwdThreads = 512;  // a block of the backward
constexpr int kWarps = kFwdThreads / 32;
constexpr int kUnroll = 4;        // 16-byte units a thread keeps in flight
constexpr float kLog2e = 1.4426950408889634f;

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
  return __float2bfloat16(x);  // round to nearest even, as .to(bf16)
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes of T into 16 / sizeof(T) f32 values, and back.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& r, float* x) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float* x) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(x[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One row's split of n columns into a scalar head (up to the first
// 16-byte boundary), nvec units of W elements and a scalar tail; start is
// the row's first element's offset in elements past a 16-byte boundary.
// Mirrors fused_ce.py:row_split.
struct Split {
  int head, nvec, tail;
};

__device__ __forceinline__ Split row_split(long long start, int n, int W) {
  Split r;
  r.head = min((int)((W - start % W) % W), n);
  r.nvec = (n - r.head) / W;
  r.tail = n - r.head - r.nvec * W;
  return r;
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

// Fold W values into the running (m, s), s = sum exp(x - m), with
// mL = m log2e kept beside m. A chunk whose values are all -inf while m
// is still -inf adds nothing (the guard).
template <int W>
__device__ __forceinline__ void fwd_chunk(const float* v, float& m, float& s,
                                          float& mL) {
  float mc = v[0];
#pragma unroll
  for (int j = 1; j < W; ++j) mc = fmaxf(mc, v[j]);
  if (mc > m) {
    s *= ex2((m - mc) * kLog2e);  // m = -inf: s = 0 * 0
    m = mc;
    mL = mc * kLog2e;
  }
  if (m == -INFINITY) return;
  float t[W];
#pragma unroll
  for (int j = 0; j < W; ++j) t[j] = ex2(fmaf(v[j], kLog2e, -mL));
#pragma unroll
  for (int w = 1; w < W; w *= 2)
#pragma unroll
    for (int j = 0; j + w < W; j += 2 * w) t[j] += t[j + w];
  s += t[0];
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
    ce_fwd_kernel(const T* __restrict__ lg, const int* __restrict__ labels,
                  float* __restrict__ per, float* __restrict__ lse_out, int V,
                  int vv, int a0) {
  constexpr int W = 16 / sizeof(T);
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const T* x = lg + row * (long long)V;
  const Split sp = row_split(a0 + row * (long long)V, vv, W);
  float m = -INFINITY, s = 0.f, mL = -INFINITY;
  float gold = 0.f;  // a label outside [0, V) hits nothing
  if (t == 0) {
    const int lab = labels[row];
    if (lab >= 0 && lab < V) gold = lab < vv ? to_f32(x[lab]) : -INFINITY;
  }
  if (t < sp.head) {
    const float v = to_f32(x[t]);
    fwd_chunk<1>(&v, m, s, mL);
  }
  if (t < sp.tail) {
    const float v = to_f32(x[sp.head + sp.nvec * W + t]);
    fwd_chunk<1>(&v, m, s, mL);
  }
  const uint4* body = reinterpret_cast<const uint4*>(x + sp.head);
  for (int i = t; i < sp.nvec; i += kFwdThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kFwdThreads < sp.nvec)
        r[u] = __ldg(body + i + u * kFwdThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kFwdThreads < sp.nvec) {
        float v[W];
        unpack16<T>(r[u], v);
        fwd_chunk<W>(v, m, s, mL);
      }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    lse_merge(m, s, m2, s2);
  }
  __shared__ float sm[kWarps], ss[kWarps];
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) {
    sm[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  if (t == 0) {
    m = sm[0];
    s = ss[0];
    for (int w = 1; w < kWarps; ++w) lse_merge(m, s, sm[w], ss[w]);
    const float lse = logf(s) + m;  // every column -inf: log 0 + -inf
    per[row] = lse - gold;
    lse_out[row] = lse;
  }
}

// dlogits of W columns from c0 in place: the one-hot and the vv mask
// only where the unit holds the label or crosses vv.
template <int W>
__device__ __forceinline__ void bwd_unit(float* v, int c0, int lab, int vv,
                                         float l, float gr) {
  if ((unsigned)(lab - c0) >= (unsigned)W && c0 + W <= vv) {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = expf(v[j] - l) * gr;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = c0 + j;
      const float p = c < vv ? expf(v[j] - l) : 0.f;
      v[j] = (p - (c == lab ? 1.f : 0.f)) * gr;
    }
  }
}

template <typename Ti, typename To>
__global__ void __launch_bounds__(kBwdThreads)
    ce_bwd_kernel(const Ti* __restrict__ lg, const int* __restrict__ labels,
                  const float* __restrict__ lse, const float* __restrict__ g,
                  To* __restrict__ dlg, int V, int vv, int a0) {
  constexpr int W =
      16 / (sizeof(Ti) < sizeof(To) ? sizeof(Ti) : sizeof(To));
  constexpr int NI = W * sizeof(Ti) / 16, NO = W * sizeof(To) / 16;
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const Ti* x = lg + row * (long long)V;
  To* d = dlg + row * (long long)V;
  const float l = lse[row], gr = g[row];
  const int lab = labels[row];
  const Split sp = row_split(a0 + row * (long long)V, V, W);
  auto scalar = [&](int c) {
    const float p = c < vv ? expf(to_f32(x[c]) - l) : 0.f;
    d[c] = from_f32<To>((p - (c == lab ? 1.f : 0.f)) * gr);
  };
  if (t < sp.head) scalar(t);
  if (t < sp.tail) scalar(sp.head + sp.nvec * W + t);
  const uint4* xin = reinterpret_cast<const uint4*>(x + sp.head);
  uint4* dout = reinterpret_cast<uint4*>(d + sp.head);
  for (int i = t; i < sp.nvec; i += kBwdThreads * kUnroll) {
    uint4 r[kUnroll][NI];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * kBwdThreads < sp.nvec)
#pragma unroll
        for (int k = 0; k < NI; ++k)
          r[u][k] = __ldg(xin + (long long)(i + u * kBwdThreads) * NI + k);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = i + u * kBwdThreads;  // unit j from its NI vectors
      if (j < sp.nvec) {
        float v[W];
#pragma unroll
        for (int k = 0; k < NI; ++k)
          unpack16<Ti>(r[u][k], v + k * (16 / sizeof(Ti)));
        bwd_unit<W>(v, sp.head + j * W, lab, vv, l, gr);
#pragma unroll
        for (int k = 0; k < NO; ++k)
          dout[(long long)j * NO + k] = pack16<To>(v + k * (16 / sizeof(To)));
      }
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* lg, const int* labels, float* per,
                       float* lse, int N, int V, int vv, int a0,
                       cudaStream_t st) {
  ce_fwd_kernel<T><<<N, kFwdThreads, 0, st>>>(static_cast<const T*>(lg),
                                              labels, per, lse, V, vv, a0);
  return cudaGetLastError();
}

template <typename Ti, typename To>
cudaError_t launch_bwd(const void* lg, const int* labels, const float* lse,
                       const float* g, void* dlg, int N, int V, int vv, int a0,
                       cudaStream_t st) {
  ce_bwd_kernel<Ti, To><<<N, kBwdThreads, 0, st>>>(
      static_cast<const Ti*>(lg), labels, lse, g, static_cast<To*>(dlg), V,
      vv, a0);
  return cudaGetLastError();
}

bool bad_shape(int N, int V, int vv, int a0, int W) {
  return N < 1 || V < 1 || vv < 1 || vv > V || a0 < 0 || a0 >= W;
}

}  // namespace

// lg [N, V] contiguous, f32 (is_bf16 = 0) or bf16 (1), its base a0
// elements past a 16-byte boundary; labels [N] int32; per, lse [N] f32
// out. Returns the cudaError_t of the launch.
extern "C" int ce_fwd_launch(const void* lg, const void* labels, void* per,
                             void* lse, int N, int V, int vv, int is_bf16,
                             int a0, void* stream) {
  if (bad_shape(N, V, vv, a0, is_bf16 ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  const int* lab = static_cast<const int*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(per);
  float* l = static_cast<float*>(lse);
  return (int)(is_bf16 ? launch_fwd<__nv_bfloat16>(lg, lab, p, l, N, V, vv,
                                                   a0, st)
                       : launch_fwd<float>(lg, lab, p, l, N, V, vv, a0, st));
}

// lg [N, V] contiguous, f32 or bf16 (in_bf16); dlg [N, V] contiguous,
// f32 or bf16 (out_bf16), laid out so that a 16-byte boundary of the
// narrower type's rows is one of the other's too; a0 is the narrower
// tensor's base offset in elements past a 16-byte boundary (the input's
// when both are one type); labels [N] int32; lse, g [N] f32.
extern "C" int ce_bwd_launch(const void* lg, const void* labels,
                             const void* lse, const void* g, void* dlg, int N,
                             int V, int vv, int in_bf16, int out_bf16, int a0,
                             void* stream) {
  if (bad_shape(N, V, vv, a0, (in_bf16 || out_bf16) ? 8 : 4))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const int* lab = static_cast<const int*>(labels);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  cudaError_t e;
  if (in_bf16 && out_bf16)
    e = launch_bwd<bf, bf>(lg, lab, l, gg, dlg, N, V, vv, a0, st);
  else if (in_bf16)
    e = launch_bwd<bf, float>(lg, lab, l, gg, dlg, N, V, vv, a0, st);
  else if (out_bf16)
    e = launch_bwd<float, bf>(lg, lab, l, gg, dlg, N, V, vv, a0, st);
  else
    e = launch_bwd<float, float>(lg, lab, l, gg, dlg, N, V, vv, a0, st);
  return (int)e;
}
