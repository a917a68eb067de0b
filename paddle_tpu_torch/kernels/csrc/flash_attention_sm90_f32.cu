// Flash attention forward and backward for Hopper (sm_90a) on the tensor
// cores for f32 inputs: f32 accumulation, (B, H, S, D) layout with D 64,
// causal or full, runtime q_off / k_off (the global positions of q[0] and
// k[0]).
//
// Replaces, for f32 inputs at D 64, the TPU kernels that
// flash_attention_sm90.cu replaces for bf16: the library Pallas kernel
// behind paddle_tpu/nn/functional/flash_attention.py:134 _pallas_flash
// (B1, forward and its custom_vjp backward), and paddle_tpu/kernels/
// flash_block.py's _fwd (pallas_call :134) and _bwd (:277 dq, :320 dk/dv)
// (B5, through the same device code). The math is theirs:
//
//   s = scale q k^T, masked (key outside Sk, or causal
//       q_off + row < k_off + key) to -inf
//   forward:  online softmax over 64-key tiles; out = acc / l, lse =
//             m + log l; a row whose every key is masked gives out 0,
//             lse -inf
//   backward: p = exp(s - lse); dV = p^T dO; dS = p (dO V^T - delta) scale;
//             dK = dS^T Q; dQ = dS K
//
// Precision: every product of f32 inputs is a 3xTF32 product. Each operand
// x is split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big)
// (x - big is exact in f32; small is 0 where big is not finite), so that
// big + small carries x to within 2^-22 of its size, and a product is taken
// as small.big + big.small + big.big on the TF32 tensor cores with f32
// accumulation: within about 2^-21 of the f32 product (the small.small
// term, below 2^-22, is dropped). This is how PyTorch's f32
// memory-efficient attention takes its products (CUTLASS's
// OpMultiplyAddFastF32).
//
// What bounds it on this card: operations. At the GPT-125M training shape
// (B 8, H 12, S 1024, D 64, causal) the forward does 12.9 GFLOP against 50
// MB, the backward 32.2 GFLOP (5 products) against 101 MB: at 67 TFLOP/s
// (f32 on the CUDA cores, where the SIMT kernels of flash_attention.cu run
// them) 0.192 and 0.481 ms; as three TF32 products at 495 TFLOP/s, 0.078
// and 0.195 ms. The design:
//
// - route: mma.sync.m16n8k8 .tf32 (the warp-level product the library
//   takes), not wgmma. TF32 wgmma reads both shared-memory operands
//   K-major only, so P V, dS K, P^T dO and dS^T Q would each need a
//   transposed copy, and with the big and small parts of both operands
//   the backward's stages (six to eight 16 KB tiles each) do not fit 227
//   KB twice. mma.sync takes its fragments from registers, loaded by hand
//   from shared memory in whatever order the product needs, so no tile is
//   transposed;
// - each streamed tile (K and V, or Q and dO) is split once per block:
//   all threads turn the landed f32 tile into a big and a small plane in
//   shared memory, so the inner loop is four shared loads and three
//   products, and the split (with its inf guard) is not repeated by every
//   warp. The resident A operands are split in registers as they are read
//   (Q once per block in the forward; Q, dO, K, V once per tile and step);
// - the tensor cores align a step's products to the largest of them and
//   to the accumulator they add them to, and drop the bits below (toward
//   zero), so the error of a sum kept in one accumulator grows with the
//   sum and with the number of steps. Each product keeps its small terms
//   in an accumulator of their own and adds it with an IEEE add at the
//   end; the backward starts a fresh big.big accumulator every step of its
//   scores and dP, the dK/dV pass takes its big.big products in 19-bit
//   halves, and sums over a row of tiles (out, dq, dk, dv) take each
//   tile's product in a fresh accumulator added in f32; delta is summed in
//   f64 (product, kScoreChain, row_delta). Against an f64 reference the
//   backward then errs less than the plain f32 version does (chip_smoke.py
//   --flash-f32 prints both), which is what lets it hold LIM_F32 against
//   the plain version where dP - delta cancels; with one running
//   accumulator it did not;
// - P and dS as the A operand straight from the accumulator: a thread's A
//   registers hold k columns t and t + 4 of an 8-wide step, its
//   accumulator columns 2t and 2t + 1; since k is summed, the step takes
//   them as they are and the B operand reads its k rows in the same order
//   (key 2t for k = t, key 2t + 1 for k = t + 4: load_b_perm);
// - tiles come by cp.async (16-byte copies, zeros past S) into a
//   two-stage ring, so the next tile but one loads while a tile is split
//   and computed; rows are padded to D + 4 floats, so every fragment load
//   (load_a, load_b_rows, load_b_perm) is free of bank conflicts;
// - one block of 8 warps per 128 rows (16 a warp), one block an SM (the
//   planes, the ring and the resident tiles take 136-206 KB);
//   causal loop bounds come from q_off / k_off once per block and per
//   warp, wholly masked tiles are neither loaded nor computed, only the
//   diagonal and edge tiles are masked element by element, and the longest
//   blocks launch first; a block that sees no key writes its outputs (out
//   0, lse -inf, or zero grads) and loads nothing; a B5 block no query sees
//   at all takes one launch that writes zero grads;
// - the backward keeps FA2's two passes and no atomics (deterministic): a
//   dQ pass per q block streaming K and V (S, dP, dQ), and a dK/dV pass per
//   k block streaming Q, dO, lse and delta (S^T, dP^T, dV, dK). Without
//   DELTA_IN the dQ pass computes delta = rowsum(dO * O) and stores it for
//   the dK/dV pass; with it (B5) delta is the caller's and O is not read.
//
// Errors: the entries return a cudaError_t.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;              // rows a block owns (queries, or keys)
constexpr int BN = 64;               // rows of a streamed tile
constexpr int kWarps = 8;            // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Geo {
  int Sq, Sk, causal, q_off, k_off;
  float scale;
};

// exp(a - b) as exp2 of (a - b) log2 e.
__device__ __forceinline__ float exp_of_diff(float a, float b) {
  return exp2f((a - b) * kLog2e);
}

// Number of keys [0, n) that query row r sees (a prefix: causal masking
// hides the keys after the diagonal).
__device__ __forceinline__ int keys_seen(const Geo& g, int r) {
  if (!g.causal) return g.Sk;
  const long long n = (long long)g.q_off + r - g.k_off + 1;
  return (int)max(0LL, min((long long)g.Sk, n));
}

// The first query row that sees key kk (Sq when none does).
__device__ __forceinline__ int first_query(const Geo& g, int kk) {
  if (!g.causal) return 0;
  const long long r = (long long)g.k_off + kk - g.q_off;
  return (int)max(0LL, min((long long)g.Sq, r));
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros where bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A [rows][D + 4] tile of f32 rows, or of TF32 bit patterns (a plane).
template <int D>
struct Tile {
  static constexpr int LD = D + 4;
  static constexpr int FLOATS = 64 * LD;     // 64 rows
};

// Rows [r0, r0 + n) of a [S, D] f32 matrix into tile[n][D + 4], zeros
// past S.
template <int D>
__device__ __forceinline__ void load_tile(float* tile,
                                          const float* __restrict__ src,
                                          int r0, int S, int n = 64) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n * C; i += kThreads) {
    const int r = i / C, c = i % C;
    const bool ok = r0 + r < S;
    cp_async16(tile + r * (D + 4) + 4 * c,
               ok ? src + (long long)(r0 + r) * D + 4 * c : src,
               ok ? 16 : 0);
  }
}

// src[r0 .. r0 + 64) into dst[64], zeros past S.
__device__ __forceinline__ void load_rows_f32(float* dst,
                                              const float* __restrict__ src,
                                              int r0, int S) {
  for (int i = threadIdx.x; i < 64; i += kThreads) {
    const bool ok = r0 + i < S;
    cp_async4(dst + i, ok ? src + r0 + i : src, ok ? 4 : 0);
  }
}

// ------------------------------------------------------------ 3xTF32

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to within 2^-22 |x|; small is 0 where big is not finite
// (x inf or NaN), so the product keeps the f32 product's inf or NaN.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(x);
  const float r = x - __uint_as_float(big);
  small = fabsf(r) < INFINITY ? to_tf32(r) : 0u;
}

// A landed 64-row f32 tile into its big and small planes (the same
// [64][D + 4] layout), all threads of the block.
template <int D>
__device__ __forceinline__ void split_tile(uint32_t* big, uint32_t* small,
                                           const float* raw) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < 64 * C; i += kThreads) {
    const int off = (i / C) * (D + 4) + 4 * (i % C);
    const float4 x = *reinterpret_cast<const float4*>(raw + off);
    uint4 b, s;
    split(x.x, b.x, s.x);
    split(x.y, b.y, s.y);
    split(x.z, b.z, s.z);
    split(x.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + off) = b;
    *reinterpret_cast<uint4*>(small + off) = s;
  }
}

// An A operand (16 x 8, TF32) in its two parts. Thread (g = lane / 4,
// t = lane % 4) holds rows g, g + 8 at k columns t (registers 0, 1) and
// t + 4 (2, 3).
struct FragA {
  uint32_t big[4], small[4];
};

// A from a [rows][D + 4] f32 tile: rows r0 + {g, g + 8}, k columns k0 +
// {t, t + 4}.
template <int D>
__device__ __forceinline__ void load_a(FragA& f, const float* x, int r0,
                                       int k0, int lane) {
  const float* p = x + (r0 + lane / 4) * (D + 4) + k0 + lane % 4;
  split(p[0], f.big[0], f.small[0]);
  split(p[8 * (D + 4)], f.big[1], f.small[1]);
  split(p[4], f.big[2], f.small[2]);
  split(p[8 * (D + 4) + 4], f.big[3], f.small[3]);
}

// A from a 16 x 8 accumulator block c (P or dS): c holds rows g, g + 8 at
// columns 2t (c[0], c[2]) and 2t + 1 (c[1], c[3]); k = t takes column 2t
// and k = t + 4 column 2t + 1, so the B operand must read its rows in that
// order (load_b_perm).
__device__ __forceinline__ void acc_a(FragA& f, const float (&c)[4]) {
  split(c[0], f.big[0], f.small[0]);
  split(c[2], f.big[1], f.small[1]);
  split(c[1], f.big[2], f.small[2]);
  split(c[3], f.big[3], f.small[3]);
}

// A B operand (8 x 8) from a tile's planes: b[0], b[1] big at k = t and
// t + 4 (n = g); b[2], b[3] their small parts.
//
// B[k][n] = x[n0 + n][k0 + k]: the rows of the tile as the columns of B
// (K^T for S = Q K^T, V^T for dP = dO V^T, ...).
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const uint32_t* big,
                                            const uint32_t* small, int n0,
                                            int k0, int lane) {
  const int i = (n0 + lane / 4) * (D + 4) + k0 + lane % 4;
  b[0] = big[i];
  b[1] = big[i + 4];
  b[2] = small[i];
  b[3] = small[i + 4];
}

// B[k][n] = x[k0 + perm(k)][n0 + n] with perm(t) = 2t, perm(t + 4) =
// 2t + 1: the tile's rows along k in the order acc_a gives A's columns.
template <int D>
__device__ __forceinline__ void load_b_perm(uint32_t (&b)[4],
                                            const uint32_t* big,
                                            const uint32_t* small, int k0,
                                            int n0, int lane) {
  const int i = (k0 + 2 * (lane % 4)) * (D + 4) + n0 + lane / 4;
  b[0] = big[i];
  b[1] = big[i + D + 4];
  b[2] = small[i];
  b[3] = small[i + D + 4];
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int N>
__device__ __forceinline__ void zero_acc(float (&c)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
}

// acc += part, one IEEE f32 add an entry.
template <int N>
__device__ __forceinline__ void add_acc(float (&acc)[N][4],
                                        const float (&part)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += part[i][e];
}

// c[j] (+)= sum over kk < KK of A_kk B_kk,j for the NJ 8-column blocks j
// (ACC: added to c; else c is overwritten), each step as three TF32
// products: big.big, and small.big and big.small into an accumulator of
// their own (2^-11 of the size, so are their errors; and two chains of
// products that do not wait on each other), added to c at the end. The
// tensor cores align a step's products to the largest of them and to the
// accumulator they add them to, and drop the bits below (toward zero), so
// a sum over many steps in one accumulator loses bits at the size of the
// whole sum: the big.big terms of every CHAIN steps start a fresh
// accumulator, added to c with IEEE f32 adds. With HL, big.big is taken
// as hi.big + lo.big, hi the top 8 significant bits of A's big part and lo
// the rest (exact; with the small terms): 19-bit products, which the
// alignment of a step's sum cuts less. a_of(FragA&, kk) and
// b_of(uint32_t (&)[4], kk, j) give the operands.
template <int KK, int NJ, int CHAIN, bool ACC, bool HL = false,
          typename FA, typename FB>
__device__ __forceinline__ void product(float (&c)[NJ][4], FA a_of,
                                        FB b_of) {
  static_assert(KK % CHAIN == 0, "chains must tile the steps");
  float cs[NJ][4];
  if (!ACC) zero_acc(c);
  zero_acc(cs);
#pragma unroll
  for (int k0 = 0; k0 < KK; k0 += CHAIN) {
    float cb[NJ][4];
    zero_acc(cb);
#pragma unroll
    for (int kk = k0; kk < k0 + CHAIN; ++kk) {
      FragA a;
      a_of(a, kk);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        hi[i] = HL ? a.big[i] & 0xffff0000u : a.big[i];
        lo[i] = __float_as_uint(__uint_as_float(a.big[i]) -
                                __uint_as_float(hi[i]));
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t b[4];
        b_of(b, kk, j);
        mma_tf32(cs[j], a.small, b[0], b[1]);
        mma_tf32(cs[j], a.big, b[2], b[3]);
        if (HL) mma_tf32(cs[j], lo, b[0], b[1]);
        mma_tf32(cb[j], hi, b[0], b[1]);
      }
    }
    add_acc(c, cb);
  }
  add_acc(c, cs);
}

// The backward's precision (B1 f32 causal at S 1024 is where it is tight:
// chip_smoke.py --flash-f32):
// - its scores and dP (sums over D) start a fresh big.big accumulator every
//   step: p = exp(s - lse) turns an error of s into a relative error of p,
//   and dS = p (dP - delta) cancels where a row sees few keys; with longer
//   chains dq, dk and dv went over LIM_F32 against the plain version on
//   some draws;
// - the dK/dV pass splits the A operand of its sums over queries (P, dS)
//   once more (product's HL): dk of the first keys sums every query's term
//   and cancels to a thousandth of its partial sums, where the bits the
//   tensor cores drop from 22-bit products showed.
// The forward and the dQ pass's sum over keys take the whole tile product
// as one chain.
constexpr int kScoreChain = 1;

// The backward's scores or dP (16 rows x 64 keys, over D) as two products
// of 32 keys, so that each half's accumulators are live alone; every
// entry is summed as in one product.
template <int D, typename FA, typename FB>
__device__ __forceinline__ void score_product(float (&c)[8][4], FA a_of,
                                              FB b_of) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    product<D / 8, 4, kScoreChain, false>(
        *reinterpret_cast<float(*)[4][4]>(&c[4 * h]), a_of,
        [&](uint32_t(&b)[4], int kk, int j) { b_of(b, kk, j + 4 * h); });
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// x / d, or 0 where d is 0 (a row that saw no key).
__device__ __forceinline__ float div_or_0(float x, float d) {
  return d == 0.f ? 0.f : x / d;
}

// Store a warp's 16-row accumulator acc (D / 8 blocks of 8 columns) as
// rows row0, row0 + 8 of a [S, D] f32 matrix (divided by d0 / d1 with
// DIVIDE), rows >= S skipped.
template <int D, bool DIVIDE>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float (&acc)[D / 8][4],
                                           int row0, int S, float d0,
                                           float d1, int lane) {
  auto f = [](float x, float d) { return DIVIDE ? div_or_0(x, d) : x; };
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = 8 * nb + 2 * (lane % 4);
    if (row0 < S)
      *reinterpret_cast<float2*>(dst + (long long)row0 * D + col) =
          make_float2(f(acc[nb][0], d0), f(acc[nb][1], d0));
    if (row0 + 8 < S)
      *reinterpret_cast<float2*>(dst + (long long)(row0 + 8) * D + col) =
          make_float2(f(acc[nb][2], d1), f(acc[nb][3], d1));
  }
}

// Zero rows [r0, r1) of a [S, D] f32 matrix, all threads of the block.
template <int D>
__device__ __forceinline__ void zero_rows(float* __restrict__ dst, int r0,
                                          int r1) {
  float4* p = reinterpret_cast<float4*>(dst + (long long)r0 * D);
  const int n = (r1 - r0) * D / 4;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Dynamic shared memory of each pass, in 64-row tiles of D + 4 floats:
// forward: the K and V ring (4) and their planes (4; Q lands there first);
// dQ: Q and dO (4), the ring (4), the planes (4), and delta; dK/dV: K and V
// (4), the Q and dO ring (4), their planes (4), the lse and delta ring and
// the current tile's lse and delta.
template <int D>
struct Smem {
  static constexpr int T = 4 * Tile<D>::FLOATS;
  static constexpr int FWD = 8 * T;
  static constexpr int DQ = 12 * T + 4 * BM;
  static constexpr int DKV = 12 * T + 4 * 6 * 64;
};

// ---------------------------------------------------------------- forward

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, Geo g) {
  constexpr int NB = D / 8, T = Tile<D>::FLOATS;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;      // longest first
  const int q_end = min(q0 + BM, g.Sq);
  const int n_tiles = (keys_seen(g, q_end - 1) + BN - 1) / BN;
  const long long qoff = (long long)bh * g.Sq * D;
  const long long koff = (long long)bh * g.Sk * D;
  float* ob = out + qoff;
  float* lb = lse + (long long)bh * g.Sq;
  if (n_tiles == 0) {                // no row sees a key: nothing to load
    zero_rows<D>(ob, q0, q_end);
    for (int i = q0 + threadIdx.x; i < q_end; i += blockDim.x)
      lb[i] = -INFINITY;
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* Kr = smem;                  // ring: K and V of tiles t, t + 1
  float* Vr = Kr + 2 * T;
  uint32_t* Kb = reinterpret_cast<uint32_t*>(Vr + 2 * T);   // planes
  uint32_t* Ks = Kb + T;
  uint32_t* Vb = Ks + T;
  uint32_t* Vs = Vb + T;
  float* Qs = reinterpret_cast<float*>(Kb);   // Q, before the first split
  load_tile<D>(Qs, q + qoff, q0, g.Sq, BM);
  load_tile<D>(Kr, k + koff, 0, g.Sk);
  load_tile<D>(Vr, v + koff, 0, g.Sk);
  cp_commit();
  if (n_tiles > 1) {
    load_tile<D>(Kr + T, k + koff, BN, g.Sk);
    load_tile<D>(Vr + T, v + koff, BN, g.Sk);
  }
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = q0 + 16 * warp;                 // this warp's 16 rows
  const int row0 = r_lo + lane / 4;                // and row0 + 8
  const bool live = r_lo < g.Sq;
  // tiles this warp computes, and those every row of it sees whole
  const int n_mine =
      live ? (keys_seen(g, min(r_lo + 15, g.Sq - 1)) + BN - 1) / BN : 0;
  const int n_whole = live ? keys_seen(g, r_lo) / BN : 0;
  const int seen0 = keys_seen(g, row0), seen1 = keys_seen(g, row0 + 8);

  cp_wait_all_but_newest();
  __syncthreads();
  FragA qf[NB];                      // this warp's Q rows, split once
#pragma unroll
  for (int kk = 0; kk < NB; ++kk) load_a<D>(qf[kk], Qs, 16 * warp, 8 * kk, lane);

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[NB][4];
  zero_acc(o);
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();                 // the planes are free
    split_tile<D>(Kb, Ks, Kr + (t & 1) * T);
    split_tile<D>(Vb, Vs, Vr + (t & 1) * T);
    __syncthreads();                 // the planes are ready, the stage free
    if (t + 2 < n_tiles) {
      load_tile<D>(Kr + (t & 1) * T, k + koff, (t + 2) * BN, g.Sk);
      load_tile<D>(Vr + (t & 1) * T, v + koff, (t + 2) * BN, g.Sk);
    }
    cp_commit();
    if (t < n_mine) {
      float sc[8][4];                // 16 rows x 64 keys
      product<NB, 8, NB, false>(
          sc, [&](FragA& a, int kk) { a = qf[kk]; },
          [&](uint32_t(&b)[4], int kk, int j) {
            load_b_rows<D>(b, Kb, Ks, 8 * j, 8 * kk, lane);
          });
      // scaled scores, masked
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] *= g.scale;
      if (t >= n_whole) {
        const int b0 = seen0 - BN * t, b1 = seen1 - BN * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane % 4) + e;
            if (col >= b0) sc[j][e] = -INFINITY;
            if (col >= b1) sc[j][2 + e] = -INFINITY;
          }
      }
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x0 = fmaxf(x0, fmaxf(sc[j][0], sc[j][1]));
        x1 = fmaxf(x1, fmaxf(sc[j][2], sc[j][3]));
      }
      const float n0 = fmaxf(m0, quad_max(x0)), n1 = fmaxf(m1, quad_max(x1));
      // a row with every key masked so far keeps m = -inf: exp against a
      // safe 0 gives p = 0 instead of -inf - -inf
      const float u0 = n0 == -INFINITY ? 0.f : n0;
      const float u1 = n1 == -INFINITY ? 0.f : n1;
      const float corr0 = exp_of_diff(m0, u0), corr1 = exp_of_diff(m1, u1);
      m0 = n0;
      m1 = n1;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][0] = exp_of_diff(sc[j][0], u0);
        sc[j][1] = exp_of_diff(sc[j][1], u0);
        sc[j][2] = exp_of_diff(sc[j][2], u1);
        sc[j][3] = exp_of_diff(sc[j][3], u1);
        s0 += sc[j][0] + sc[j][1];
        s1 += sc[j][2] + sc[j][3];
      }
      l0 = l0 * corr0 + quad_sum(s0);
      l1 = l1 * corr1 + quad_sum(s1);
      // o = o corr + p V (the keys of block j are step j's k)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        o[nb][0] *= corr0;
        o[nb][1] *= corr0;
        o[nb][2] *= corr1;
        o[nb][3] *= corr1;
      }
      product<8, NB, 8, true>(
          o, [&](FragA& a, int j) { acc_a(a, sc[j]); },
          [&](uint32_t(&b)[4], int j, int nb) {
            load_b_perm<D>(b, Vb, Vs, 8 * j, 8 * nb, lane);
          });
    }
    cp_wait_all_but_newest();        // tile t + 1 has landed
  }

  store_rows<D, true>(ob, o, row0, g.Sq, l0, l1, lane);
  if (lane % 4 == 0) {
    if (row0 < g.Sq) lb[row0] = l0 == 0.f ? -INFINITY : m0 + logf(l0);
    if (row0 + 8 < g.Sq)
      lb[row0 + 8] = l1 == 0.f ? -INFINITY : m1 + logf(l1);
  }
}

// ------------------------------------------------------- backward: dQ pass

// Part of delta = rowsum(dO * O) of one row, summed in f64: the columns
// d = part (mod 4). Four parts combined by two shuffles and rounded to f32
// once. dS = p (dP - delta) cancels where a row sees few keys (one key:
// dP = delta), so the rounding of an f32 sum of delta reached the
// gradients of the first keys, which sum over every query.
__device__ __forceinline__ double row_delta(const float* __restrict__ o,
                                            const float* __restrict__ dout,
                                            int part, int D) {
  double acc = 0;
  for (int d = part; d < D; d += 4)
    acc = fma((double)dout[d], (double)o[d], acc);
  return acc;
}

// DELTA_IN false (B1): delta = rowsum(dO * O) here, stored for the dK/dV
// pass. DELTA_IN true (B5): delta is an input, o is not read.
template <int D, bool DELTA_IN>
__global__ void __launch_bounds__(kThreads, 1)
    dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ o,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   float* __restrict__ dq, Geo g) {
  constexpr int NB = D / 8, T = Tile<D>::FLOATS;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int q_end = min(q0 + BM, g.Sq);
  const int n_tiles = (keys_seen(g, q_end - 1) + BN - 1) / BN;
  const long long qoff = (long long)bh * g.Sq * D;
  const long long koff = (long long)bh * g.Sk * D;
  float* db = delta + (long long)bh * g.Sq;
  if (n_tiles == 0) {                // no row sees a key: dq = 0
    zero_rows<D>(dq + qoff, q0, q_end);
    if constexpr (!DELTA_IN)
      for (int r = q0 + threadIdx.x; r < q_end; r += blockDim.x) {
        const float* orow = o + qoff + (long long)r * D;
        const float* drow = dout + qoff + (long long)r * D;
        // the shuffles' order below: (p0 + p1) + (p2 + p3)
        db[r] = (float)((row_delta(orow, drow, 0, D) +
                         row_delta(orow, drow, 1, D)) +
                        (row_delta(orow, drow, 2, D) +
                         row_delta(orow, drow, 3, D)));
      }
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // 128 rows
  float* Ds = Qs + 2 * T;            // dO, 128 rows
  float* Kr = Ds + 2 * T;            // ring
  float* Vr = Kr + 2 * T;
  uint32_t* Kb = reinterpret_cast<uint32_t*>(Vr + 2 * T);   // planes
  uint32_t* Ks = Kb + T;
  uint32_t* Vb = Ks + T;
  uint32_t* Vs = Vb + T;
  float* dls = reinterpret_cast<float*>(Vs + T);   // delta of the rows
  load_tile<D>(Qs, q + qoff, q0, g.Sq, BM);
  load_tile<D>(Ds, dout + qoff, q0, g.Sq, BM);
  load_tile<D>(Kr, k + koff, 0, g.Sk);
  load_tile<D>(Vr, v + koff, 0, g.Sk);
  cp_commit();
  if (n_tiles > 1) {
    load_tile<D>(Kr + T, k + koff, BN, g.Sk);
    load_tile<D>(Vr + T, v + koff, BN, g.Sk);
  }
  cp_commit();

  // delta of the block's rows into dls (read after the loop's barriers):
  // four threads a row (row_delta's order), 64 rows a pass
  for (int i = threadIdx.x / 4; i < BM; i += kThreads / 4) {
    const int r = q0 + i, part = threadIdx.x % 4;
    double x = 0;
    if constexpr (DELTA_IN) {
      x = r < g.Sq && part == 0 ? db[r] : 0.f;
    } else if (r < g.Sq) {
      x = row_delta(o + qoff + (long long)r * D,
                    dout + qoff + (long long)r * D, part, D);
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (part == 0) {
      dls[i] = (float)x;
      if constexpr (!DELTA_IN)
        if (r < g.Sq) db[r] = (float)x;
    }
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r_lo = q0 + 16 * warp;
  const int row0 = r_lo + lane / 4;
  const bool live = r_lo < g.Sq;
  const int n_mine =
      live ? (keys_seen(g, min(r_lo + 15, g.Sq - 1)) + BN - 1) / BN : 0;
  const int n_whole = live ? keys_seen(g, r_lo) / BN : 0;
  const int seen0 = keys_seen(g, row0), seen1 = keys_seen(g, row0 + 8);
  // this thread's rows: lse (-inf, or a row past Sq: +inf, so p = 0)
  const float* lsb = lse + (long long)bh * g.Sq;
  float ls0 = row0 < g.Sq ? lsb[row0] : INFINITY;
  float ls1 = row0 + 8 < g.Sq ? lsb[row0 + 8] : INFINITY;
  if (ls0 == -INFINITY) ls0 = INFINITY;
  if (ls1 == -INFINITY) ls1 = INFINITY;

  float acc[NB][4];
  zero_acc(acc);
  cp_wait_all_but_newest();
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    split_tile<D>(Kb, Ks, Kr + (t & 1) * T);
    split_tile<D>(Vb, Vs, Vr + (t & 1) * T);
    __syncthreads();
    if (t + 2 < n_tiles) {
      load_tile<D>(Kr + (t & 1) * T, k + koff, (t + 2) * BN, g.Sk);
      load_tile<D>(Vr + (t & 1) * T, v + koff, (t + 2) * BN, g.Sk);
    }
    cp_commit();
    if (t < n_mine) {
      float sc[8][4], dp[8][4];
      score_product<D>(
          sc,
          [&](FragA& a, int kk) { load_a<D>(a, Qs, 16 * warp, 8 * kk, lane); },
          [&](uint32_t(&b)[4], int kk, int j) {
            load_b_rows<D>(b, Kb, Ks, 8 * j, 8 * kk, lane);
          });
      score_product<D>(
          dp,
          [&](FragA& a, int kk) { load_a<D>(a, Ds, 16 * warp, 8 * kk, lane); },
          [&](uint32_t(&b)[4], int kk, int j) {
            load_b_rows<D>(b, Vb, Vs, 8 * j, 8 * kk, lane);
          });
      const float dl0 = dls[row0 - q0], dl1 = dls[row0 + 8 - q0];
      const bool whole = t < n_whole;
      const int b0 = seen0 - BN * t, b1 = seen1 - BN * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * (lane % 4) + e;
          const float p0 =
              (whole || col < b0) ? exp_of_diff(sc[j][e] * g.scale, ls0) : 0.f;
          const float p1 = (whole || col < b1)
                               ? exp_of_diff(sc[j][2 + e] * g.scale, ls1)
                               : 0.f;
          dp[j][e] = p0 * (dp[j][e] - dl0) * g.scale;
          dp[j][2 + e] = p1 * (dp[j][2 + e] - dl1) * g.scale;
        }
      // dq += dS K (the keys of block j are step j's k)
      product<8, NB, 8, true>(
          acc, [&](FragA& a, int j) { acc_a(a, dp[j]); },
          [&](uint32_t(&b)[4], int j, int nb) {
            load_b_perm<D>(b, Kb, Ks, 8 * j, 8 * nb, lane);
          });
    }
    cp_wait_all_but_newest();
  }
  store_rows<D, false>(dq + qoff, acc, row0, g.Sq, 0.f, 0.f, lane);
}

// --------------------------------------------------- backward: dK/dV pass

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, Geo g) {
  constexpr int NB = D / 8, T = Tile<D>::FLOATS;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BM;              // the first keys see the most
  const int k_end = min(k0 + BM, g.Sk);
  const int fq = first_query(g, k0);
  const int qt_lo = fq / BN;
  const int n_tiles = fq < g.Sq ? (g.Sq + BN - 1) / BN - qt_lo : 0;
  const long long qoff = (long long)bh * g.Sq * D;
  const long long koff = (long long)bh * g.Sk * D;
  const long long rows = (long long)bh * g.Sq;
  if (n_tiles == 0) {                // no query sees a key: zero grads
    zero_rows<D>(dk + koff, k0, k_end);
    zero_rows<D>(dv + koff, k0, k_end);
    return;
  }

  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // 128 rows
  float* Vs = Ks + 2 * T;            // 128 rows
  float* Qr = Vs + 2 * T;            // ring
  float* Dr = Qr + 2 * T;            // dO ring
  uint32_t* Qb = reinterpret_cast<uint32_t*>(Dr + 2 * T);   // planes
  uint32_t* Qsm = Qb + T;
  uint32_t* Db = Qsm + T;
  uint32_t* Dsm = Db + T;
  float* Lr = reinterpret_cast<float*>(Dsm + T);   // lse ring, 2 x 64
  float* Er = Lr + 2 * 64;                         // delta ring
  float* ls = Er + 2 * 64;           // the current tile's lse (-inf as +inf)
  float* dls = ls + 64;              // and delta
  const int r_first = qt_lo * BN;
  load_tile<D>(Ks, k + koff, k0, g.Sk, BM);
  load_tile<D>(Vs, v + koff, k0, g.Sk, BM);
  load_tile<D>(Qr, q + qoff, r_first, g.Sq);
  load_tile<D>(Dr, dout + qoff, r_first, g.Sq);
  load_rows_f32(Lr, lse + rows, r_first, g.Sq);
  load_rows_f32(Er, delta + rows, r_first, g.Sq);
  cp_commit();
  if (n_tiles > 1) {
    load_tile<D>(Qr + T, q + qoff, r_first + BN, g.Sq);
    load_tile<D>(Dr + T, dout + qoff, r_first + BN, g.Sq);
    load_rows_f32(Lr + 64, lse + rows, r_first + BN, g.Sq);
    load_rows_f32(Er + 64, delta + rows, r_first + BN, g.Sq);
  }
  cp_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kc = k0 + 16 * warp;                   // this warp's 16 keys
  const int krow0 = kc + lane / 4;                 // and krow0 + 8
  const bool live = kc < g.Sk;
  // q tiles below t_lo see none of these keys; from t_whole on, every
  // query of a tile sees every key
  const int t_lo = live ? first_query(g, kc) / BN : 1 << 30;
  const int t_whole =
      live ? (first_query(g, min(kc + 15, g.Sk - 1)) + BN - 1) / BN : 1 << 30;
  const int fq0 = first_query(g, krow0), fq1 = first_query(g, krow0 + 8);

  float adk[NB][4], adv[NB][4];
  zero_acc(adk);
  zero_acc(adv);
  cp_wait_all_but_newest();
  for (int t = 0; t < n_tiles; ++t) {
    const int ta = qt_lo + t, st_ = t & 1;
    __syncthreads();
    split_tile<D>(Qb, Qsm, Qr + st_ * T);
    split_tile<D>(Db, Dsm, Dr + st_ * T);
    // queries past Sq read lse 0 and delta 0 against zero rows of Q and
    // dO, so their terms are 0; a query that saw no key (lse -inf) gets
    // p = 0
    for (int i = threadIdx.x; i < 64; i += kThreads) {
      const float x = Lr[64 * st_ + i];
      ls[i] = x == -INFINITY ? INFINITY : x;
      dls[i] = Er[64 * st_ + i];
    }
    __syncthreads();
    if (t + 2 < n_tiles) {
      const int r0 = (ta + 2) * BN;
      load_tile<D>(Qr + st_ * T, q + qoff, r0, g.Sq);
      load_tile<D>(Dr + st_ * T, dout + qoff, r0, g.Sq);
      load_rows_f32(Lr + 64 * st_, lse + rows, r0, g.Sq);
      load_rows_f32(Er + 64 * st_, delta + rows, r0, g.Sq);
    }
    cp_commit();
    if (ta >= t_lo) {
      float st[8][4], dpt[8][4];     // 16 keys x 64 queries
      score_product<D>(
          st,
          [&](FragA& a, int kk) { load_a<D>(a, Ks, 16 * warp, 8 * kk, lane); },
          [&](uint32_t(&b)[4], int kk, int j) {
            load_b_rows<D>(b, Qb, Qsm, 8 * j, 8 * kk, lane);
          });
      score_product<D>(
          dpt,
          [&](FragA& a, int kk) { load_a<D>(a, Vs, 16 * warp, 8 * kk, lane); },
          [&](uint32_t(&b)[4], int kk, int j) {
            load_b_rows<D>(b, Db, Dsm, 8 * j, 8 * kk, lane);
          });
      const bool whole = ta >= t_whole;
      const int b0 = fq0 - BN * ta, b1 = fq1 - BN * ta;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 lq = *reinterpret_cast<const float2*>(ls + col);
        const float2 dq2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lc = e ? lq.y : lq.x, dc = e ? dq2.y : dq2.x;
          const float p0 = (whole || col + e >= b0)
                               ? exp_of_diff(st[j][e] * g.scale, lc) : 0.f;
          const float p1 = (whole || col + e >= b1)
                               ? exp_of_diff(st[j][2 + e] * g.scale, lc)
                               : 0.f;
          st[j][e] = p0;
          st[j][2 + e] = p1;
          dpt[j][e] = p0 * (dpt[j][e] - dc) * g.scale;
          dpt[j][2 + e] = p1 * (dpt[j][2 + e] - dc) * g.scale;
        }
      }
      // dv += P^T dO, then dk += dS^T Q (the queries of block j are step
      // j's k)
      product<8, NB, 8, true, true>(
          adv, [&](FragA& a, int j) { acc_a(a, st[j]); },
          [&](uint32_t(&b)[4], int j, int nb) {
            load_b_perm<D>(b, Db, Dsm, 8 * j, 8 * nb, lane);
          });
      product<8, NB, 8, true, true>(
          adk, [&](FragA& a, int j) { acc_a(a, dpt[j]); },
          [&](uint32_t(&b)[4], int j, int nb) {
            load_b_perm<D>(b, Qb, Qsm, 8 * j, 8 * nb, lane);
          });
    }
    cp_wait_all_but_newest();
  }
  store_rows<D, false>(dk + koff, adk, krow0, g.Sk, 0.f, 0.f, lane);
  store_rows<D, false>(dv + koff, adv, krow0, g.Sk, 0.f, 0.f, lane);
}

// ------------------------------------------- a block that no query sees

// Its gradients are zero: dq (na 16-byte words), dk and dv (nb each) in one
// launch that reads nothing. flash_attention_sm90.cu has the same writer on
// uint4: each source builds into a library of its own (one nvcc each, all
// at once), and a kernel launched from this library's entries must live in
// it, so the copy stays rather than a header that would rebuild the bf16
// kernels' source too.
__global__ void __launch_bounds__(256)
    zero_grads_kernel(float4* __restrict__ dq, long long na,
                      float4* __restrict__ dk, float4* __restrict__ dv,
                      long long nb) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < na || i < nb; i += step) {
    if (i < na) dq[i] = z;
    if (i < nb) {
      dk[i] = z;
      dv[i] = z;
    }
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t prepare(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D>
int fwd(const float* q, const float* k, const float* v, float* out,
        float* lse, int BH, const Geo& g, cudaStream_t st) {
  auto kern = fwd_tf32_kernel<D>;
  constexpr int smem = Smem<D>::FWD;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(BH, (g.Sq + BM - 1) / BM), kThreads, smem, st>>>(q, k, v, out,
                                                               lse, g);
  return (int)cudaGetLastError();
}

// The dQ pass (which, without DELTA_IN, writes delta), then the dK/dV pass
// on the same stream.
template <int D, bool DELTA_IN>
int bwd(const float* q, const float* k, const float* v, const float* o,
        const float* dout, const float* lse, float* delta, float* dq,
        float* dk, float* dv, int BH, const Geo& g, cudaStream_t st) {
  auto kq = dq_tf32_kernel<D, DELTA_IN>;
  auto kkv = dkv_tf32_kernel<D>;
  constexpr int sq = Smem<D>::DQ, skv = Smem<D>::DKV;
  cudaError_t e = prepare(kq, sq);
  if (e == cudaSuccess) e = prepare(kkv, skv);
  if (e != cudaSuccess) return (int)e;
  kq<<<dim3(BH, (g.Sq + BM - 1) / BM), kThreads, sq, st>>>(
      q, k, v, o, dout, lse, delta, dq, g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kkv<<<dim3(BH, (g.Sk + BM - 1) / BM), kThreads, skv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, g);
  return (int)cudaGetLastError();
}

bool geo_ok(int BH, int Sq, int Sk, int D, int is_bf16) {
  return is_bf16 == 0 && BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 &&
         D == 64;
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Sk, D], out [BH, Sq, D] contiguous f32 (is_bf16
// must be 0), 16-byte aligned, D 64; lse [BH, Sq] f32 out.
extern "C" int flash_fwd_tf32_launch(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int BH, int Sq, int Sk, int D,
                                     int causal, int q_off, int k_off,
                                     float scale, int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  return fwd<64>(static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(out),
                 static_cast<float*>(lse), BH, g,
                 static_cast<cudaStream_t>(stream));
}

// The same layouts; o / dout [BH, Sq, D] (16-byte aligned); lse [BH, Sq]
// f32 from the forward; delta [BH, Sq] f32 scratch; dq [BH, Sq, D], dk /
// dv [BH, Sk, D] out. Two launches: dQ (+ delta), then dK/dV.
extern "C" int flash_bwd_tf32_launch(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk,
                                     void* dv, int BH, int Sq, int Sk, int D,
                                     int causal, int q_off, int k_off,
                                     float scale, int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  return bwd<64, false>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv), BH, g,
      static_cast<cudaStream_t>(stream));
}

// B5's backward: the same without O; lse and delta [BH, Sq] f32 are the
// caller's (global residuals of a ring, or of one block with any lse
// cotangent folded into delta) and are only read. Two launches, or one
// that writes zero grads for a block no query sees.
extern "C" int flash_block_bwd_tf32_launch(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           void* dq, void* dk, void* dv,
                                           int BH, int Sq, int Sk, int D,
                                           int causal, int q_off, int k_off,
                                           float scale, int is_bf16,
                                           void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal && (long long)q_off + Sq - 1 < k_off) {
    // a block wholly in the causal future (a ring's): zero grads, one
    // launch, nothing read
    const long long na = (long long)BH * Sq * D / 4, nb = (long long)BH * Sk * D / 4;
    const long long blocks = ((na > nb ? na : nb) + 255) / 256;
    zero_grads_kernel<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
        static_cast<float4*>(dq), na, static_cast<float4*>(dk),
        static_cast<float4*>(dv), nb);
    return (int)cudaGetLastError();
  }
  // DELTA_IN never writes delta: the const_cast only fits the shared
  // kernel signature
  return bwd<64, true>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), nullptr, static_cast<const float*>(dout),
      static_cast<const float*>(lse),
      const_cast<float*>(static_cast<const float*>(delta)),
      static_cast<float*>(dq), static_cast<float*>(dk),
      static_cast<float*>(dv), BH, g, st);
}

// Dynamic shared memory (bytes) a kernel asks for: pass 0 forward, 1 dQ,
// 2 dK/dV; -1 for another shape.
extern "C" int flash_tf32_smem_bytes(int pass, int D) {
  if (D != 64) return -1;
  switch (pass) {
    case 0: return Smem<64>::FWD;
    case 1: return Smem<64>::DQ;
    case 2: return Smem<64>::DKV;
    default: return -1;
  }
}
