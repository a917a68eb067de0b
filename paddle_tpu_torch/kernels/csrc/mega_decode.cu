// One-dispatch S=1 decode layer step for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/kernels/mega_decode.py:mega_decode_step
// (bodies _kernel_row / _kernel_whole, math in _attend). Per batch row b:
//   ctx[b]  = softmax over {l < pos[b]} of the OLD cache, plus the incoming
//             k/v row merged into the same softmax at its incoming precision;
//   kc[b, pos[b]] = k[b], vc[b, pos[b]] = v[b] (cast to the cache type),
//             only when 0 <= pos[b] < L — nothing is written otherwise.
// GQA: the g = nh / nkv query heads of one kv head share its cache rows;
// the cache is never repeated.
//
// What bounds it on this card: bytes. An S=1 step reads each cache row once
// and does 4 flops per cached element (q.k and p.v), about 1 flop per byte
// for a bf16 cache — far under the H100's ~20 f32 flops per byte of HBM
// bandwidth. The least time is the cache rows it must read,
// 2 * sum_b min(pos[b], L) * nkv * hd * sizeof(cache), over 3.35 TB/s.
//
// Design: one block per (b, kv head), 8 warps. The warps stride over the
// cached positions; each warp keeps an online softmax (running max, sum and
// f32 accumulator) for the g query rows, a lane holding head-dim elements
// lane, lane+32, ... so each cache row is read as coalesced 32-lane runs.
// The warps' partial states merge in shared memory together with the new
// row's logit and value. f32 accumulation throughout. Kept simple on purpose:
// no TMA, no wgmma, no split over L across blocks (B * nkv blocks is below
// the 132 SMs at small batch — that is a later optimisation).
//
// In-place write without a barrier: the strict l < pos[b] mask means no
// block ever reads the position it writes, and blocks of other kv heads
// write disjoint slices of the same row, so the write may land while other
// blocks are still reading.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxPerLane = 8;  // head_dim <= 256

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename TQ, typename TC, int G>
__global__ void __launch_bounds__(kWarps * 32)
    mega_decode_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k_new,
                       const TQ* __restrict__ v_new, TC* kc, TC* vc,
                       const int* __restrict__ pos, TQ* __restrict__ ctx,
                       int L, int nkv, int hd, float scale) {
  const int b = blockIdx.x / nkv;
  const int h = blockIdx.x % nkv;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nh = nkv * G;
  const int npl = (hd + 31) / 32;
  const int p = pos[b];
  const int n_old = min(max(p, 0), L);

  // shared: [kWarps][G][hd] accumulators, [kWarps][G] maxima,
  // [kWarps][G] sums, [G] new-row logits
  extern __shared__ float smem[];
  float* s_acc = smem;
  float* s_m = s_acc + kWarps * G * hd;
  float* s_s = s_m + kWarps * G;
  float* s_new = s_s + kWarps * G;

  const size_t q_row0 = (size_t)b * nh + (size_t)h * G;  // first q head
  float qr[G][kMaxPerLane];
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      qr[j][i] = (i < npl && d < hd) ? to_f32(q[(q_row0 + j) * hd + d]) : 0.f;
    }
  }

  float m[G], s[G], acc[G][kMaxPerLane];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    m[j] = -INFINITY;
    s[j] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) acc[j][i] = 0.f;
  }

  const size_t row_stride = (size_t)nkv * hd;
  const size_t base = ((size_t)b * L * nkv + h) * hd;
  for (int l = warp; l < n_old; l += kWarps) {
    const TC* kr = kc + base + (size_t)l * row_stride;
    const TC* vr = vc + base + (size_t)l * row_stride;
    float kv[kMaxPerLane], vv[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      const bool in = i < npl && d < hd;
      kv[i] = in ? to_f32(kr[d]) : 0.f;
      vv[i] = in ? to_f32(vr[d]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) part += qr[j][i] * kv[i];
      const float logit = warp_sum(part) * scale;
      const float m_new = fmaxf(m[j], logit);
      const float corr = expf(m[j] - m_new);  // 0 on the first row
      const float pr = expf(logit - m_new);
      s[j] = s[j] * corr + pr;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i)
        acc[j][i] = acc[j][i] * corr + pr * vv[i];
      m[j] = m_new;
    }
  }

  // publish each warp's partial softmax state
#pragma unroll
  for (int j = 0; j < G; ++j) {
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      const int d = lane + 32 * i;
      if (i < npl && d < hd) s_acc[(warp * G + j) * hd + d] = acc[j][i];
    }
    if (lane == 0) {
      s_m[warp * G + j] = m[j];
      s_s[warp * G + j] = s[j];
    }
  }
  // the new row's logit per query head, at the row's incoming precision
  if (warp < G) {
    const int j = warp;
    float part = 0.f;
    for (int d = lane; d < hd; d += 32)
      part += to_f32(q[(q_row0 + j) * hd + d]) *
              to_f32(k_new[((size_t)b * nkv + h) * hd + d]);
    const float logit = warp_sum(part) * scale;
    if (lane == 0) s_new[j] = logit;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * hd; idx += blockDim.x) {
    const int j = idx / hd;
    const int d = idx - j * hd;
    const float ln = s_new[j];
    float mx = ln;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w * G + j]);
    const float p_new = expf(ln - mx);
    float den = p_new;
    float num = p_new * to_f32(v_new[((size_t)b * nkv + h) * hd + d]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w * G + j] - mx);  // 0 for an idle warp
      den += s_s[w * G + j] * c;
      num += s_acc[(w * G + j) * hd + d] * c;
    }
    ctx[(q_row0 + j) * hd + d] = from_f32<TQ>(num / den);
  }

  if (p >= 0 && p < L) {
    const size_t dst = ((size_t)b * L + p) * nkv * hd + (size_t)h * hd;
    const size_t src = ((size_t)b * nkv + h) * hd;
    for (int d = threadIdx.x; d < hd; d += blockDim.x) {
      kc[dst + d] = from_f32<TC>(to_f32(k_new[src + d]));
      vc[dst + d] = from_f32<TC>(to_f32(v_new[src + d]));
    }
  }
}

template <typename TQ, typename TC, int G>
cudaError_t launch_g(const void* q, const void* k, const void* v, void* kc,
                     void* vc, const int* pos, void* ctx, int B, int L,
                     int nkv, int hd, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kWarps * G * hd +
                                       2 * (size_t)kWarps * G + G);
  auto kern = mega_decode_kernel<TQ, TC, G>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B * nkv, kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TQ*>(v), static_cast<TC*>(kc), static_cast<TC*>(vc),
      pos, static_cast<TQ*>(ctx), L, nkv, hd, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC>
cudaError_t launch_typed(const void* q, const void* k, const void* v,
                         void* kc, void* vc, const int* pos, void* ctx, int B,
                         int L, int nkv, int g, int hd, float scale,
                         cudaStream_t stream) {
  switch (g) {
    case 1:
      return launch_g<TQ, TC, 1>(q, k, v, kc, vc, pos, ctx, B, L, nkv, hd,
                                 scale, stream);
    case 2:
      return launch_g<TQ, TC, 2>(q, k, v, kc, vc, pos, ctx, B, L, nkv, hd,
                                 scale, stream);
    case 4:
      return launch_g<TQ, TC, 4>(q, k, v, kc, vc, pos, ctx, B, L, nkv, hd,
                                 scale, stream);
    case 8:
      return launch_g<TQ, TC, 8>(q, k, v, kc, vc, pos, ctx, B, L, nkv, hd,
                                 scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,nkv*g,hd], k/v [B,1,nkv,hd] (f32 or bf16, q_bf16); kc/vc
// [B,L,nkv,hd] (f32 or bf16, cache_bf16), all contiguous; pos [B] int32;
// ctx [B,1,nkv*g,hd] at q's type. Returns the cudaError_t of the launch.
extern "C" int mega_decode_launch(const void* q, const void* k, const void* v,
                                  void* kc, void* vc, const void* pos,
                                  void* ctx, int B, int L, int nkv, int g,
                                  int hd, int q_bf16, int cache_bf16,
                                  float scale, void* stream) {
  if (hd < 1 || hd > 32 * kMaxPerLane || B < 1 || L < 1 || nkv < 1)
    return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_bf16) {
    e = cache_bf16 ? launch_typed<__nv_bfloat16, __nv_bfloat16>(
                         q, k, v, kc, vc, p, ctx, B, L, nkv, g, hd, scale, st)
                   : launch_typed<__nv_bfloat16, float>(
                         q, k, v, kc, vc, p, ctx, B, L, nkv, g, hd, scale, st);
  } else {
    e = cache_bf16 ? launch_typed<float, __nv_bfloat16>(
                         q, k, v, kc, vc, p, ctx, B, L, nkv, g, hd, scale, st)
                   : launch_typed<float, float>(q, k, v, kc, vc, p, ctx, B, L,
                                                nkv, g, hd, scale, st);
  }
  return (int)e;
}
