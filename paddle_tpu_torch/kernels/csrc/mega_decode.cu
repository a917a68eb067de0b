// One-dispatch S=1 decode layer step for Hopper (sm_90a), split over the
// cache with the merge inside the same launch.
//
// Replaces the TPU kernel paddle_tpu/kernels/mega_decode.py:mega_decode_step
// (bodies _kernel_row / _kernel_whole, math in _attend). Per batch row b:
//   ctx[b]  = softmax over {l < pos[b]} of the OLD cache, plus the incoming
//             k/v row merged into the same softmax at its incoming precision;
//   kc[b, pos[b]] = k[b], vc[b, pos[b]] = v[b] (cast to the cache type),
//             only when 0 <= pos[b] < L — nothing is written otherwise.
// GQA: the g = nh / nkv query heads of one kv head share its cache rows;
// the cache is never repeated. Any g >= 1: a block takes G <= 8 of them (G
// the largest divisor of g up to 8, the template's instantiations 1-8), and
// a grid axis of nsub = g / G sub-groups covers the rest within the same
// launch. Each sub-group has its own partials and its own ticket, so its
// last block folds only its own G heads; sub-group 0's writes the new row.
// The blocks of the sub-groups of one (b, kv head, chunk) read the same
// cache rows, so for g > 8 the cache is read nsub times (from L2 where the
// blocks run together). The accumulators acc[G][hd / lanes a row] and q
// take most registers: at G = 8 a thread holds 64 of each at hd = 128
// (ptxas: 210-230 registers, no spill), so a block of G = 5..8 heads runs
// fewer blocks an SM than G <= 4 (72-128 registers).
//
// What bounds it on this card: bytes. An S=1 step reads each cache row once
// and does 4 flops per cached element (q.k and p.v), about 1 flop per byte
// for a bf16 cache — far under the H100's ~20 f32 flops per byte of HBM
// bandwidth. The least time is the cache rows it must read,
// 2 * sum_b min(pos[b], L) * nkv * hd * sizeof(cache), over 3.35 TB/s.
//
// Design, against what holds a one-block-per-(b, kv head) kernel back:
// - The grid is ((b * nkv + kv head) * nsub + sub-group, chunk of L). The
//   wrapper picks the chunk length from L, B, nkv * nsub and the SM count
//   alone (it never reads pos, which lives on the card), so that a full
//   cache fills every SM several times.
//   A block whose chunk starts at or past min(max(pos[b], 0), L) reads and
//   writes nothing; it only counts itself (below).
// - Wide loads: a lane loads VB bytes of a row at once (16, or 8, 4, 2 when
//   hd * sizeof(cache) or the base pointers allow no more), a group of
//   `lpr` lanes holds a row (8 lanes for hd = 64 bf16, so one warp load
//   covers 4 rows), and q.k reduces inside the group with log2(lpr)
//   shuffles. Loads bypass L1 and are marked evict-first (ld.global.cs):
//   each row is read once.
// - Loads in flight: each group issues the K and V loads of U rows before
//   any expf (U such that they fill 32 registers: 4 rows for a bf16 row of
//   16-byte loads, so one batch covers 64 rows of a block, and a thread
//   stays at 64 registers, 8 blocks an SM), then takes their logits,
//   rescales its accumulator once for the U rows and adds them. f32
//   accumulation throughout. More rows a batch (64 registers of loads)
//   or 8 warps a block measured slower: fewer blocks fit an SM.
// - Few round trips in a row: the kernel is short, so its time is the
//   chain of dependent memory trips of its slowest block plus the merge.
//   What does not depend on pos (q, the new k and v rows) is loaded
//   together with pos; the merge reads the workspace in one pass.
// - One launch a layer: each chunk's block merges its groups and warps into
//   one partial softmax state (m, s, acc[g][hd]) relative to its own max and
//   writes it to an f32 workspace. The last block of a (b, kv head) to
//   finish — an atomic ticket taken after a __threadfence() — folds the
//   partials of the chunks that hold rows, in chunk order, into the new
//   row's state (logit, weight 1, value), writes ctx, writes the new row,
//   and resets the ticket counter to 0 for the next launch. Chunks past
//   pos[b] are never read, so nothing stale in the workspace is ever used,
//   and no workspace needs a memset.
// - exp of (m - M) is taken only for a finite m: an empty group, warp or
//   chunk contributes exactly 0, never NaN from (-inf) - (-inf). With no
//   old row (pos[b] <= 0) ctx = (1 * v) / 1 = v exactly.
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

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxPerLane = 8;   // elements of a row a lane holds: hd <= 256
constexpr int kRawRegs = 32;     // registers a batch's K and V loads take

__device__ __forceinline__ float ld_f32(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void st_f32(void* p, size_t i, float x, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(p)[i] = x;
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

// VB bytes of a row as 32-bit words (a 2-byte load fills the low half)
template <int VB>
struct Raw {
  uint32_t w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Raw<VB> load_raw(const void* p) {
  Raw<VB> r;
  if constexpr (VB == 16) {
    const uint4 x = __ldcs(static_cast<const uint4*>(p));
    r.w[0] = x.x; r.w[1] = x.y; r.w[2] = x.z; r.w[3] = x.w;
  } else if constexpr (VB == 8) {
    const uint2 x = __ldcs(static_cast<const uint2*>(p));
    r.w[0] = x.x; r.w[1] = x.y;
  } else if constexpr (VB == 4) {
    r.w[0] = __ldcs(static_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldcs(static_cast<const unsigned short*>(p));
  }
  return r;
}

template <int VB>
__device__ __forceinline__ Raw<VB> zero_raw() {
  Raw<VB> r;
#pragma unroll
  for (int i = 0; i < (VB >= 4 ? VB / 4 : 1); ++i) r.w[i] = 0u;
  return r;
}

// element e of a load, widened to f32
template <typename TC, int VB>
__device__ __forceinline__ float elem(const Raw<VB>& r, int e) {
  if constexpr (sizeof(TC) == 4) {
    return __uint_as_float(r.w[e]);
  } else {
    const uint32_t w = r.w[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

// exp(m - M) for a state whose max is m, 0 for an empty one (m = -inf)
__device__ __forceinline__ float weight(float m, float M) {
  return m == -INFINITY ? 0.f : expf(m - M);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Workspace, per ((b * nkv + h) * nsub + sub-group, chunk) partial:
// ws[part * 2G + j] = m_j, ws[part * 2G + G + j] = s_j (the first
// B * nkv * nsub * nchunks * 2G floats), then acc[(part * G + j) * hd + d].
// counters: one int per (b, h, sub-group), 0 between launches.
template <typename TC, int G, int VB>
__global__ void __launch_bounds__(kThreads)
    mega_decode_kernel(const void* __restrict__ q, const void* __restrict__ kn,
                       const void* __restrict__ vn, TC* kc, TC* vc,
                       const int* __restrict__ pos, void* __restrict__ ctx,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int L, int nkv, int nsub, int hd, int chunk,
                       float scale, int q_bf16) {
  constexpr int VEC = VB / (int)sizeof(TC);  // elements per load
  constexpr int MAXV = kMaxPerLane / VEC;    // loads per lane per row, most
  constexpr int WORDS = VB >= 4 ? VB / 4 : 1;
  // rows per group per batch: a batch's K and V loads fill kRawRegs
  // registers (fewer rows at g = 4, 8, whose q and acc take more)
  constexpr int U0 = kRawRegs / (2 * MAXV * WORDS);
  constexpr int U = G <= 2 ? U0 : (2 * U0 / G > 0 ? 2 * U0 / G : 1);
  const int nchunks = gridDim.y;
  const int bhs = blockIdx.x;               // (b * nkv + h) * nsub + sg
  const int bh = bhs / nsub;
  const int sg = bhs - bh * nsub;
  const int b = bh / nkv;
  const int h = bh - b * nkv;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nv = hd / VEC;                   // loads per row
  int lpr = 1;                               // lanes per row: a power of 2
  while (lpr < nv && lpr < 32) lpr <<= 1;
  const int vpl = (nv + lpr - 1) / lpr;      // loads per lane per row
  const int li = lane & (lpr - 1);
  const int nslots = kWarps * (32 / lpr);    // rows the block reads at once
  const int slot = warp * (32 / lpr) + lane / lpr;
  const int nh = nkv * G * nsub;
  // first q head of the block's sub-group
  const size_t q_row0 = (size_t)b * nh + ((size_t)h * nsub + sg) * G;
  const size_t row_new = ((size_t)b * nkv + h) * hd;
  const size_t part = (size_t)bhs * nchunks + c;
  float* ws_acc = ws + (size_t)gridDim.x * nchunks * 2 * G;

  // shared: the new k and v rows [hd] each (f32 of their incoming values),
  // the new row's logits [G], then the warps' states: accumulators
  // [kWarps][G][hd], maxima and sums [kWarps][G]
  extern __shared__ float smem[];
  __shared__ int s_last;
  float* s_kn = smem;
  float* s_vn = s_kn + hd;
  float* s_ln = s_vn + hd;
  float* s_acc = s_ln + G;
  float* s_m = s_acc + kWarps * G * hd;
  float* s_s = s_m + kWarps * G;

  // what does not depend on pos is loaded together with it
  const int p = pos[b];
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    s_kn[d] = ld_f32(kn, row_new + d, q_bf16);
    s_vn[d] = ld_f32(vn, row_new + d, q_bf16);
  }
  float qr[G][kMaxPerLane];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int v = 0; v < MAXV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = v * lpr + li;
        qr[j][v * VEC + e] =
            (v < vpl && col < nv)
                ? ld_f32(q, (q_row0 + j) * hd + col * VEC + e, q_bf16)
                : 0.f;
      }
  const int n_old = min(max(p, 0), L);
  const int r0 = c * chunk;
  const int r1 = min(r0 + chunk, n_old);

  if (r0 < r1) {  // block-uniform: this chunk holds old rows
    float m[G], s[G], acc[G][kMaxPerLane];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      m[j] = -INFINITY;
      s[j] = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) acc[j][i] = 0.f;
    }

    const size_t row_stride = (size_t)nkv * hd;
    const size_t head0 = ((size_t)b * L * nkv + h) * hd + (size_t)li * VEC;
    for (int base = r0; base < r1; base += nslots * U) {
      // every K and V load of the U rows before any arithmetic on them
      Raw<VB> kr[U][MAXV], vr[U][MAXV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int row = base + u * nslots + slot;
#pragma unroll
        for (int v = 0; v < MAXV; ++v) {
          if (row < r1 && v < vpl && v * lpr + li < nv) {
            const size_t off = head0 + (size_t)row * row_stride +
                               (size_t)v * lpr * VEC;
            kr[u][v] = load_raw<VB>(kc + off);
            vr[u][v] = load_raw<VB>(vc + off);
          } else {
            kr[u][v] = zero_raw<VB>();
            vr[u][v] = zero_raw<VB>();
          }
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        float lg[U];
        float mx = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int v = 0; v < MAXV; ++v)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              dot += qr[j][v * VEC + e] * elem<TC, VB>(kr[u][v], e);
          for (int o = lpr >> 1; o > 0; o >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, o);
          const bool in = base + u * nslots + slot < r1;
          lg[u] = in ? dot * scale : -INFINITY;
          mx = fmaxf(mx, lg[u]);
        }
        const float m_new = fmaxf(m[j], mx);
        const float corr = weight(m[j], m_new);  // once per U rows
        s[j] *= corr;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) acc[j][i] *= corr;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float pr = weight(lg[u], m_new);
          s[j] += pr;
#pragma unroll
          for (int v = 0; v < MAXV; ++v)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[j][v * VEC + e] += pr * elem<TC, VB>(vr[u][v], e);
        }
        m[j] = m_new;
      }
    }

    // the warp's row groups into one state (xor over whole groups)
    for (int o = lpr; o < 32; o <<= 1) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float om = __shfl_xor_sync(0xffffffffu, m[j], o);
        const float os = __shfl_xor_sync(0xffffffffu, s[j], o);
        const float M = fmaxf(m[j], om);
        const float c1 = weight(m[j], M), c2 = weight(om, M);
        s[j] = s[j] * c1 + os * c2;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          if (i / VEC < vpl) {
            const float oa = __shfl_xor_sync(0xffffffffu, acc[j][i], o);
            acc[j][i] = acc[j][i] * c1 + oa * c2;
          }
        }
        m[j] = M;
      }
    }
    if (lane < lpr) {
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int v = 0; v < MAXV; ++v)
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int col = v * lpr + li;
            if (v < vpl && col < nv)
              s_acc[(warp * G + j) * hd + col * VEC + e] = acc[j][v * VEC + e];
          }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          s_m[warp * G + j] = m[j];
          s_s[warp * G + j] = s[j];
        }
      }
    }
    __syncthreads();
    // the warps into the chunk's partial, relative to the chunk's max
    for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
      const int j = idx / hd;
      const int d = idx - j * hd;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * G + j]);
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float wt = weight(s_m[w * G + j], M);
        a += s_acc[(w * G + j) * hd + d] * wt;
        sum += s_s[w * G + j] * wt;
      }
      ws_acc[(part * G + j) * hd + d] = a;
      if (d == 0) {
        ws[part * 2 * G + j] = M;
        ws[part * 2 * G + G + j] = sum;
      }
    }
  }

  // every block of (b, h, sg) takes a ticket; the last one merges. Only a
  // block that wrote a partial fences: an empty one has nothing to publish
  if (r0 < r1) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(&counters[bhs], 1);
    s_last = prev == nchunks - 1;
    if (s_last) counters[bhs] = 0;  // every block has counted: ready again
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the new row's logit per query head, at the row's incoming precision,
  // from q as the row groups hold it (warp 0)
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int v = 0; v < MAXV; ++v)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int col = v * lpr + li;
          if (v < vpl && col < nv)
            dot += qr[j][v * VEC + e] * s_kn[col * VEC + e];
        }
      for (int o = lpr >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) s_ln[j] = dot * scale;
    }
  }
  __syncthreads();
  // one pass over the chunks that hold rows, starting from the new row
  // (weight 1 against its own logit); 4 chunks' loads in flight at once
  const int n_act = (n_old + chunk - 1) / chunk;
  const size_t p0 = (size_t)bhs * nchunks;
  for (int idx = threadIdx.x; idx < G * hd; idx += kThreads) {
    const int j = idx / hd;
    const int d = idx - j * hd;
    float M = s_ln[j], den = 1.f, num = s_vn[d];
    for (int k0 = 0; k0 < n_act; k0 += 4) {
      float mk[4], sk[4], ak[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const size_t pk = p0 + k0 + i;
        const bool in = k0 + i < n_act;
        mk[i] = in ? __ldcg(ws + pk * 2 * G + j) : -INFINITY;
        sk[i] = in ? __ldcg(ws + pk * 2 * G + G + j) : 0.f;
        ak[i] = in ? __ldcg(ws_acc + (pk * G + j) * hd + d) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float M2 = fmaxf(M, mk[i]);
        const float c1 = expf(M - M2), c2 = weight(mk[i], M2);
        den = den * c1 + sk[i] * c2;
        num = num * c1 + ak[i] * c2;
        M = M2;
      }
    }
    st_f32(ctx, (q_row0 + j) * hd + d, num / den, q_bf16);
  }
  if (sg == 0 && p >= 0 && p < L) {  // one sub-group writes the new row
    const size_t dst = ((size_t)b * L + p) * nkv * hd + (size_t)h * hd;
    for (int d = threadIdx.x; d < hd; d += kThreads) {
      kc[dst + d] = from_f32<TC>(s_kn[d]);
      vc[dst + d] = from_f32<TC>(s_vn[d]);
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void *kc, *vc;
  const int* pos;
  void* ctx;
  float* ws;
  int* counters;
  int B, L, nkv, nsub, hd, chunk, nchunks, q_bf16;
  float scale;
  cudaStream_t stream;
};

template <typename TC, int G, int VB>
cudaError_t launch_vb(const Args& a) {
  const size_t smem = sizeof(float) * (2 * (size_t)a.hd + G +
                                       (size_t)kWarps * G * (a.hd + 2));
  auto kern = mega_decode_kernel<TC, G, VB>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(a.B * a.nkv * a.nsub, a.nchunks), kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, static_cast<TC*>(a.kc), static_cast<TC*>(a.vc), a.pos,
      a.ctx, a.ws, a.counters, a.L, a.nkv, a.nsub, a.hd, a.chunk, a.scale,
      a.q_bf16);
  return cudaGetLastError();
}

template <typename TC, int G>
cudaError_t launch_g(const Args& a, int vec_bytes) {
  switch (vec_bytes) {
    case 16: return launch_vb<TC, G, 16>(a);
    case 8: return launch_vb<TC, G, 8>(a);
    case 4: return launch_vb<TC, G, 4>(a);
    case 2:
      if constexpr (sizeof(TC) == 2) return launch_vb<TC, G, 2>(a);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename TC>
cudaError_t launch_typed(const Args& a, int g, int vec_bytes) {
  switch (g) {
    case 1: return launch_g<TC, 1>(a, vec_bytes);
    case 2: return launch_g<TC, 2>(a, vec_bytes);
    case 3: return launch_g<TC, 3>(a, vec_bytes);
    case 4: return launch_g<TC, 4>(a, vec_bytes);
    case 5: return launch_g<TC, 5>(a, vec_bytes);
    case 6: return launch_g<TC, 6>(a, vec_bytes);
    case 7: return launch_g<TC, 7>(a, vec_bytes);
    case 8: return launch_g<TC, 8>(a, vec_bytes);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,1,nkv*g*nsub,hd], k/v [B,1,nkv,hd] (f32 or bf16, q_bf16); kc/vc
// [B,L,nkv,hd] (f32 or bf16, cache_bf16), all contiguous; pos [B] int32;
// ctx [B,1,nkv*g*nsub,hd] at q's type; g (the heads a block takes) in
// 1..8, nsub >= 1 sub-groups of g heads per kv head. ws: f32,
// B*nkv*nsub*nchunks*g*(hd+2) floats; counters: B*nkv*nsub ints, 0 before
// the first launch (each launch leaves them 0). Chunks of `chunk` rows,
// nchunks of them, cover [0, L) once.
// vec_bytes: bytes a lane loads at once, dividing hd * sizeof(cache) and
// the alignment of kc and vc. Returns the cudaError_t of the launch.
extern "C" int mega_decode_launch(const void* q, const void* k, const void* v,
                                  void* kc, void* vc, const void* pos,
                                  void* ctx, void* ws, void* counters, int B,
                                  int L, int nkv, int g, int nsub, int hd,
                                  int chunk, int nchunks, int vec_bytes,
                                  int q_bf16, int cache_bf16, float scale,
                                  void* stream) {
  const int elem = cache_bf16 ? 2 : 4;
  if (hd < 1 || hd > 32 * kMaxPerLane || B < 1 || L < 1 || nkv < 1 ||
      g < 1 || g > 8 || nsub < 1 || chunk < 1 || nchunks < 1 ||
      (long long)chunk * nchunks < L || (long long)chunk * (nchunks - 1) >= L ||
      vec_bytes < elem || vec_bytes > 16 || (hd * elem) % vec_bytes)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, kc, vc, static_cast<const int*>(pos), ctx,
         static_cast<float*>(ws), static_cast<int*>(counters), B, L, nkv, nsub,
         hd, chunk, nchunks, q_bf16, scale, static_cast<cudaStream_t>(stream)};
  return (int)(cache_bf16 ? launch_typed<__nv_bfloat16>(a, g, vec_bytes)
                          : launch_typed<float>(a, g, vec_bytes));
}
