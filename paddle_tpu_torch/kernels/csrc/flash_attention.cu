// Flash attention forward and backward for Hopper (sm_90a), (B, H, S, D)
// layout, f32 or bf16 inputs, f32 accumulation, causal or full, with the
// global positions q_off / k_off of q[0] / k[0] for causal masking.
//
// Replaces the TPU kernel behind paddle_tpu/nn/functional/
// flash_attention.py:_pallas_flash (the library Pallas kernel
// jax.experimental.pallas.ops.tpu.flash_attention, forward and its
// custom_vjp backward). The math is the one paddle_tpu writes out in
// kernels/flash_block.py (_fwd, _bwd, compute_delta):
//
//   s = scale * q k^T, masked (col outside Sk, row outside Sq, or causal
//       q_off + row < k_off + col) to -inf
//   forward:  online softmax over key tiles; out = acc / l, lse = m + log l;
//             a row whose every key is masked gives out = 0, lse = -inf
//   backward: delta = rowsum(dO * O); p = exp(s - lse);
//             dV = p^T dO; dS = p * (dO V^T - delta) * scale;
//             dK = dS^T Q; dQ = dS K
//
// Three kernels, one block of 256 threads per 64-row tile each:
//   flash_fwd_kernel   per (b, h, q tile): walks the key tiles, keeps the
//                      running (max, sum) and the 64 x D output tile in
//                      registers;
//   flash_dq_kernel    per (b, h, q tile): computes delta for its rows (and
//                      stores it for the next kernel), then walks the key
//                      tiles accumulating dQ; with DELTA_IN it reads a
//                      given delta instead and reads no O (below);
//   flash_dkv_kernel   per (b, h, k tile): walks the query tiles that can
//                      see it, accumulating dK and dV.
// The backward is FA2-shaped and uses no atomics, so it is deterministic.
//
// The same forward is also B5's, paddle_tpu/kernels/flash_block.py:
// flash_block_attention (_fwd): attention of q against one k/v block at
// global offsets, returning (out, lse) for sequence-parallel rings; a
// block wholly in the causal future skips every key tile and writes out 0,
// lse -inf. B5's backward (flash_block_attention_bwd, _bwd) is
// flash_block_bwd_launch: the same two passes against GLOBAL (lse, delta)
// residuals, delta given by the caller (rowsum(dO * O) of the merged
// output, minus any lse cotangent), so the dQ pass is instantiated with
// DELTA_IN: it neither reads O nor writes delta, which a ring shares
// across its sp block steps. At the sp training step's ring shape (B 8,
// H 12, 256-row blocks, D 64, bf16) a block that every query sees moves
// ~12.6 MB for 1.6 GFLOP forward: bytes bound it at the tensor-core rate,
// and this kernel's own limit is its f32 FMA rate, as below.
//
// What bounds it on this card: operations. At the GPT-125M training shape
// (B 8, H 12, S 1024, D 64, causal) the forward does ~12.9 GFLOP against
// ~50 MB of traffic; at the bf16 tensor-core rate the bound is bytes, but
// this first kernel runs its products as f32 FMAs on the CUDA cores (67
// TFLOP/s peak), so its own limit is the FMA rate and the shared-memory
// loads feeding it. The design keeps the tiles in shared memory and a
// 4 x 4 register micro-tile per thread (rows ty*4+i as float4 reads of a
// transposed tile, columns tx+16j as conflict-free scalar reads of a tile
// padded to D+1), so each shared load feeds ~3 FMAs. Causal blocks skip
// the key (or query) tiles that are wholly masked, and the grid is
// launched last tile first so the longest blocks start early. wgmma, TMA
// and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 64;          // rows of a tile (queries or keys)
constexpr int BC = 64;          // columns of a tile
constexpr int kThreads = 256;   // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int PT = BC + 4;      // padded row of a transposed P / dS tile

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
  return __float2bfloat16(x);
}

struct Geo {
  int Sq, Sk, D, causal, q_off, k_off;
  float scale;
};

__device__ __forceinline__ bool visible(const Geo& g, int qi, int ki) {
  return qi < g.Sq && ki < g.Sk &&
         (!g.causal || (long long)g.q_off + qi >= (long long)g.k_off + ki);
}

// Does any (query row in [q0, q0 + BR), key in [k0, k0 + BC)) pair see
// each other? Uniform over a block.
__device__ __forceinline__ bool tile_live(const Geo& g, int q0, int k0) {
  if (!g.causal) return true;
  const int q_last = min(q0 + BR, g.Sq) - 1;
  return (long long)g.q_off + q_last >= (long long)g.k_off + k0;
}

// tile[r][d] (row stride ld) <- src rows [r0, r0 + rows) of a [S, D]
// matrix, zero outside; consecutive threads take consecutive d.
template <typename T, int DM>
__device__ __forceinline__ void load_rows(float* tile, int ld,
                                          const T* __restrict__ src, int r0,
                                          int S, int D) {
  for (int idx = threadIdx.x; idx < BR * DM; idx += kThreads) {
    const int r = idx / DM, d = idx % DM;
    const int gr = r0 + r;
    tile[r * ld + d] =
        (gr < S && d < D) ? to_f32(src[(long long)gr * D + d]) : 0.f;
  }
}

// tile[d][r] (row stride BR) <- the same rows, transposed; consecutive
// threads take consecutive r so the shared-memory writes do not collide.
template <typename T, int DM>
__device__ __forceinline__ void load_rows_t(float* tile,
                                            const T* __restrict__ src, int r0,
                                            int S, int D) {
  for (int idx = threadIdx.x; idx < BR * DM; idx += kThreads) {
    const int r = idx % BR, d = idx / BR;
    const int gr = r0 + r;
    tile[d * BR + r] =
        (gr < S && d < D) ? to_f32(src[(long long)gr * D + d]) : 0.f;
  }
}

// ---------------------------------------------------------------- forward

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, Geo g) {
  constexpr int NJ = DM / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // [DM][BR]
  float* Ks = Qt + DM * BR;           // [BC][DM + 1]
  float* Vs = Ks + BC * (DM + 1);     // [BC][DM]
  float* Pt = Vs + BC * DM;           // [BC][PT]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const long long bh = blockIdx.y;
  const T* qb = q + bh * g.Sq * g.D;
  const T* kb = k + bh * g.Sk * g.D;
  const T* vb = v + bh * g.Sk * g.D;

  load_rows_t<T, DM>(Qt, qb, q0, g.Sq, g.D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (g.Sk + BC - 1) / BC;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BC;
    if (!tile_live(g, q0, k0)) break;  // later key tiles are later still
    __syncthreads();                    // previous tile's readers are done
    load_rows<T, DM>(Ks, DM + 1, kb, k0, g.Sk, g.D);
    load_rows<T, DM>(Vs, DM, vb, k0, g.Sk, g.D);
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 8
    for (int d = 0; d < DM; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * BR + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kv = Ks[(tx + 16 * j) * (DM + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(qa[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(g, qi, k0 + tx + 16 * j) ? s[i][j] * g.scale
                                                   : -INFINITY;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      // a row with every key masked so far keeps m = -inf; exp against a
      // safe 0 zeroes its probabilities instead of making -inf - -inf
      const float ms = (mn == -INFINITY) ? 0.f : mn;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - ms);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - ms);
      l[i] = l[i] * corr + rs;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * PT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[c * PT + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vv = Vs[c * DM + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pa[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = out + bh * g.Sq * g.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.D) ob[(long long)qi * g.D + d] = from_f32<T>(acc[i][j] * inv);
    }
    if (tx == 0)
      lse[bh * g.Sq + qi] = l[i] == 0.f ? -INFINITY : m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------- backward: dQ pass

// DELTA_IN false (B1): delta = rowsum(dO * O) here, stored for the dK/dV
// pass. DELTA_IN true (B5): delta is an input, o is not read.
template <typename T, int DM, bool DELTA_IN>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq, Geo g) {
  constexpr int NJ = DM / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                   // [DM][BR]
  float* dOt = Qt + DM * BR;          // [DM][BR]
  float* Ks = dOt + DM * BR;          // [BC][DM + 1]
  float* Vs = Ks + BC * (DM + 1);     // [BC][DM + 1]
  float* dSt = Vs + BC * (DM + 1);    // [BC][PT]
  float* lse_s = dSt + BC * PT;       // [BR]
  float* dl_s = lse_s + BR;           // [BR]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const long long bh = blockIdx.y;
  const long long qoff = bh * g.Sq * g.D;
  const T* kb = k + bh * g.Sk * g.D;
  const T* vb = v + bh * g.Sk * g.D;

  load_rows_t<T, DM>(Qt, q + qoff, q0, g.Sq, g.D);
  load_rows_t<T, DM>(dOt, dout + qoff, q0, g.Sq, g.D);
  if constexpr (DELTA_IN) {
    if (tid < BR) {
      const int qi = q0 + tid;
      const float ls = qi < g.Sq ? lse[bh * g.Sq + qi] : 0.f;
      lse_s[tid] = (ls == -INFINITY) ? 0.f : ls;
      dl_s[tid] = qi < g.Sq ? delta[bh * g.Sq + qi] : 0.f;
    }
  } else {
    // delta = rowsum(dO * O): four threads per row, then a 4-lane shuffle
    const int r = tid / 4, part = tid % 4, qi = q0 + r;
    float acc = 0.f;
    if (qi < g.Sq)
      for (int d = part; d < g.D; d += 4) {
        const long long at = qoff + (long long)qi * g.D + d;
        acc = fmaf(to_f32(dout[at]), to_f32(o[at]), acc);
      }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      dl_s[r] = acc;
      const float ls = qi < g.Sq ? lse[bh * g.Sq + qi] : 0.f;
      lse_s[r] = (ls == -INFINITY) ? 0.f : ls;
      if (qi < g.Sq) delta[bh * g.Sq + qi] = acc;
    }
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int nk = (g.Sk + BC - 1) / BC;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BC;
    if (!tile_live(g, q0, k0)) break;
    __syncthreads();
    load_rows<T, DM>(Ks, DM + 1, kb, k0, g.Sk, g.D);
    load_rows<T, DM>(Vs, DM + 1, vb, k0, g.Sk, g.D);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * BR + ty * 4]);
      const float4 ov = *reinterpret_cast<const float4*>(&dOt[d * BR + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float kv = Ks[c * (DM + 1) + d];
        const float vv = Vs[c * (DM + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(qa[i], kv, s[i][j]);
          dp[i][j] = fmaf(oa[i], vv, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = visible(g, qi, k0 + tx + 16 * j)
                            ? expf(s[i][j] * g.scale - lse_s[r])
                            : 0.f;
        s[i][j] = p * (dp[i][j] - dl_s[r]) * g.scale;   // dS
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSt[(tx + 16 * j) * PT + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BC; ++c) {
      const float4 sv =
          *reinterpret_cast<const float4*>(&dSt[c * PT + ty * 4]);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float kv = Ks[c * (DM + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(sa[i], kv, acc[i][j]);
      }
    }
  }

  T* qb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= g.Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.D) qb[(long long)qi * g.D + d] = from_f32<T>(acc[i][j]);
    }
  }
}

// --------------------------------------------------- backward: dK/dV pass

template <typename T, int DM>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Geo g) {
  constexpr int NJ = DM / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;                   // [DM][BC]
  float* Vt = Kt + DM * BC;           // [DM][BC]
  float* Qs = Vt + DM * BC;           // [BR][DM + 1]
  float* dOs = Qs + BR * (DM + 1);    // [BR][DM + 1]
  float* Ps = dOs + BR * (DM + 1);    // [BR][PT]   p^T stored q-major
  float* dSs = Ps + BR * PT;          // [BR][PT]
  float* lse_s = dSs + BR * PT;       // [BR]
  float* dl_s = lse_s + BR;           // [BR]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = (gridDim.x - 1 - blockIdx.x) * BC;
  const long long bh = blockIdx.y;
  const long long koff = bh * g.Sk * g.D;
  const T* qb = q + bh * g.Sq * g.D;
  const T* ob = dout + bh * g.Sq * g.D;

  load_rows_t<T, DM>(Kt, k + koff, k0, g.Sk, g.D);
  load_rows_t<T, DM>(Vt, v + koff, k0, g.Sk, g.D);

  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  const int nq = (g.Sq + BR - 1) / BR;
  for (int qt = 0; qt < nq; ++qt) {
    const int q0 = qt * BR;
    if (!tile_live(g, q0, k0)) continue;   // earlier query tiles see less
    __syncthreads();
    load_rows<T, DM>(Qs, DM + 1, qb, q0, g.Sq, g.D);
    load_rows<T, DM>(dOs, DM + 1, ob, q0, g.Sq, g.D);
    if (tid < BR) {
      const int qi = q0 + tid;
      const float ls = qi < g.Sq ? lse[bh * g.Sq + qi] : 0.f;
      lse_s[tid] = (ls == -INFINITY) ? 0.f : ls;
      dl_s[tid] = qi < g.Sq ? delta[bh * g.Sq + qi] : 0.f;
    }
    __syncthreads();

    // transposed scores: rows are keys ty*4+i, columns queries tx+16j
    float s[4][4] = {}, dp[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < DM; ++d) {
      const float4 kv = *reinterpret_cast<const float4*>(&Kt[d * BC + ty * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&Vt[d * BC + ty * 4]);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float qv = Qs[r * (DM + 1) + d];
        const float ov = dOs[r * (DM + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(ka[i], qv, s[i][j]);
          dp[i][j] = fmaf(va[i], ov, dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j, qi = q0 + r;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = visible(g, qi, k0 + ty * 4 + i)
                   ? expf(s[i][j] * g.scale - lse_s[r])
                   : 0.f;
        ds[i] = p[i] * (dp[i][j] - dl_s[r]) * g.scale;
      }
      *reinterpret_cast<float4*>(&Ps[r * PT + ty * 4]) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(&dSs[r * PT + ty * 4]) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BR; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[r * PT + ty * 4]);
      const float4 sv = *reinterpret_cast<const float4*>(&dSs[r * PT + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float ov = dOs[r * (DM + 1) + d];
        const float qv = Qs[r * (DM + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i][j] = fmaf(pa[i], ov, av[i][j]);
          ak[i][j] = fmaf(sa[i], qv, ak[i][j]);
        }
      }
    }
  }

  T* dkb = dk + koff;
  T* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ki = k0 + ty * 4 + i;
    if (ki >= g.Sk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < g.D) {
        dkb[(long long)ki * g.D + d] = from_f32<T>(ak[i][j]);
        dvb[(long long)ki * g.D + d] = from_f32<T>(av[i][j]);
      }
    }
  }
}

// ------------------------------------------------------------- launchers

template <int DM>
constexpr size_t fwd_smem() {
  return sizeof(float) * (DM * BR + BC * (DM + 1) + BC * DM + BC * PT);
}
template <int DM>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * DM * BR + 2 * BC * (DM + 1) + BC * PT + 2 * BR);
}
template <int DM>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         (2 * DM * BC + 2 * BR * (DM + 1) + 2 * BR * PT + 2 * BR);
}

template <typename T, int DM>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int BH, const Geo& g, cudaStream_t st) {
  auto kern = flash_fwd_kernel<T, DM>;
  constexpr size_t smem = fwd_smem<DM>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((g.Sq + BR - 1) / BR, BH);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, g);
  return cudaGetLastError();
}

template <typename T, int DM, bool DELTA_IN>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int BH, const Geo& g, cudaStream_t st) {
  auto kq = flash_dq_kernel<T, DM, DELTA_IN>;
  auto kkv = flash_dkv_kernel<T, DM>;
  constexpr size_t sq = dq_smem<DM>(), skv = dkv_smem<DM>();
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sq);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)skv);
  if (e != cudaSuccess) return e;
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* oo = static_cast<const T*>(o);
  const T* dd = static_cast<const T*>(dout);
  // dQ first: without DELTA_IN it writes delta, which the dK/dV pass
  // reads (same stream)
  kq<<<dim3((g.Sq + BR - 1) / BR, BH), kThreads, sq, st>>>(
      qq, kk, vv, oo, dd, lse, delta, static_cast<T*>(dq), g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kkv<<<dim3((g.Sk + BC - 1) / BC, BH), kThreads, skv, st>>>(
      qq, kk, vv, dd, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  return cudaGetLastError();
}

bool geo_ok(int BH, int Sq, int Sk, int D) {
  return BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 && D >= 1 && D <= 128;
}

template <bool DELTA_IN>
int bwd_any(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const float* l, float* dl, void* dq, void* dk,
            void* dv, int BH, const Geo& g, int is_bf16, cudaStream_t st) {
  if (is_bf16)
    return g.D <= 64 ? (int)bwd<__nv_bfloat16, 64, DELTA_IN>(
                           q, k, v, o, dout, l, dl, dq, dk, dv, BH, g, st)
                     : (int)bwd<__nv_bfloat16, 128, DELTA_IN>(
                           q, k, v, o, dout, l, dl, dq, dk, dv, BH, g, st);
  return g.D <= 64 ? (int)bwd<float, 64, DELTA_IN>(q, k, v, o, dout, l, dl,
                                                   dq, dk, dv, BH, g, st)
                   : (int)bwd<float, 128, DELTA_IN>(q, k, v, o, dout, l, dl,
                                                    dq, dk, dv, BH, g, st);
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Sk, D], out [BH, Sq, D] contiguous of one type
// (is_bf16 0: f32, 1: bf16); lse [BH, Sq] f32 out. D <= 128.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int BH, int Sq, int Sk,
                                int D, int causal, int q_off, int k_off,
                                float scale, int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, D, causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return D <= 64 ? (int)fwd<__nv_bfloat16, 64>(q, k, v, out, l, BH, g, st)
                   : (int)fwd<__nv_bfloat16, 128>(q, k, v, out, l, BH, g, st);
  return D <= 64 ? (int)fwd<float, 64>(q, k, v, out, l, BH, g, st)
                 : (int)fwd<float, 128>(q, k, v, out, l, BH, g, st);
}

// The same layouts; o / dout [BH, Sq, D]; lse [BH, Sq] f32 from the
// forward; delta [BH, Sq] f32 scratch; dq [BH, Sq, D], dk / dv [BH, Sk, D]
// out at the inputs' type. Two launches: dQ (+ delta), then dK/dV.
extern "C" int flash_bwd_launch(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int BH, int Sq, int Sk,
                                int D, int causal, int q_off, int k_off,
                                float scale, int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, D, causal, q_off, k_off, scale};
  return bwd_any<false>(q, k, v, o, dout, static_cast<const float*>(lse),
                        static_cast<float*>(delta), dq, dk, dv, BH, g,
                        is_bf16, static_cast<cudaStream_t>(stream));
}

// B5's backward: the same layouts without O; lse and delta [BH, Sq] f32
// are the caller's (global residuals of a ring, or of one block with any
// lse cotangent folded into delta) and are only read. Two launches: dQ,
// then dK/dV.
extern "C" int flash_block_bwd_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int BH,
                                      int Sq, int Sk, int D, int causal,
                                      int q_off, int k_off, float scale,
                                      int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, D, causal, q_off, k_off, scale};
  // DELTA_IN never writes delta: the const_cast only fits the shared
  // kernel signature
  return bwd_any<true>(q, k, v, nullptr, dout,
                       static_cast<const float*>(lse),
                       const_cast<float*>(static_cast<const float*>(delta)),
                       dq, dk, dv, BH, g, is_bf16,
                       static_cast<cudaStream_t>(stream));
}
