// Flash attention forward and backward for Hopper (sm_90a) on the tensor
// cores: bf16 inputs, f32 accumulation, (B, H, S, D) layout with D 64 or
// 128, causal or full, runtime q_off / k_off (the global positions of q[0]
// and k[0]).
//
// Replaces, for bf16 inputs, the same TPU kernels as flash_attention.cu
// (whose SIMT kernels keep the f32 inputs): the library Pallas kernel
// behind paddle_tpu/nn/functional/flash_attention.py:_pallas_flash (B1)
// and paddle_tpu/kernels/flash_block.py's _fwd / _bwd (B5, through the
// same device code). The math:
//
//   s = scale q k^T, masked (key outside Sk, or causal
//       q_off + row < k_off + key) to -inf
//   forward:  online softmax over 64-key tiles; p = exp(s - m) with m the
//             running row max, l its row sum; out = acc / l, lse =
//             m + log l; a row whose every key is masked gives out 0,
//             lse -inf
//   backward: p = exp(s - lse); dV = p^T dO; dS = p (dO V^T - delta) scale;
//             dK = dS^T Q; dQ = dS K
//
// Precision: every product is taken as an f32 product of the inputs, as
// paddle_tpu's B5 kernels take it (kernels/flash_block.py's _fwd_kernel
// and _bwd widen q, k and v to f32). P and dS, which a bf16 operand would
// round by up to 2^-8 of their size, go into their products as bf16
// parts: in the forward P as three (hi + mid + lo, within 2^-24, as f32),
// because out feeds the backward's delta = rowsum(dO out), where one bf16
// step of out moves the gradients of a row that sees few keys by more
// than a bf16 step (with two parts, within 2^-16, chip_smoke.py's Ulysses
// check of such gradients went over its limit); in the backward P and dS
// as two (hi + lo, within 2^-16),
// whose results are rounded to bf16 and feed nothing. _pallas_flash (B1's
// TPU kernel) rounds P and dS to bf16 instead; this kernel computes its
// function at least as precisely, and one plain version (f32 products)
// holds B1 and B5 alike.
//
// What bounds it on this card: at the GPT-125M training shape (B 8, H 12,
// S 1024, D 64, causal) the forward does 12.9 GFLOP against 50 MB, the
// backward 32.2 GFLOP (counted as 5 products) against 101 MB: bytes bound
// the forward at the bf16 tensor-core rate (989 TFLOP/s), operations the
// backward. The design:
//
// - every product is a wgmma.mma_async m64n64k16 (bf16 x bf16 -> f32):
//   S = Q K^T and dP = dO V^T with both operands K-major in shared memory;
//   P V, dS K, P^T dO and dS^T Q with the bf16 parts of P / dS as
//   the register A operand (the f32 accumulator's fragment is the A
//   fragment of the next product, so P never goes through shared memory)
//   and B MN-major in shared memory (the transpose bit);
// - tiles come by TMA (3-D tensor maps [BH, S, D] with 128-byte swizzle,
//   built on the host per call; rows past S inside a head are zero-filled)
//   into a two-stage ring with full / empty mbarriers, fed by one producer
//   warp; the consumer warpgroups (64 rows each, one or two per block)
//   take the registers the producer warpgroup gives up (setmaxnreg);
// - causal tiles: the loop bounds come from q_off / k_off once per block,
//   the producer never loads a wholly masked tile, only tiles across the
//   diagonal or the Sk edge are masked element by element, and a block
//   that sees no key at all writes its outputs (out 0, lse -inf, or zero
//   grads) before it loads anything; a B5 block no query sees at all
//   (a ring's future block) takes one launch that writes zero grads. The
//   longest blocks launch first;
// - the backward keeps FA2's two passes and no atomics (deterministic): a
//   dQ pass per q tile streaming K and V (S, dP, dQ in two parts: 4
//   products), then a dK/dV pass per k tile streaming Q, dO, lse and delta
//   (S^T, dP^T, dV and dK in two parts each: 6); 10 products per visible
//   pair where one pass with rounded P and dS would take 5 (the forward
//   takes 4: S, and P V in three parts). Without DELTA_IN the dQ pass
//   computes delta = rowsum(dO * O) and stores it for the dK/dV pass; with
//   it (B5) delta is the caller's and O is not read.
// - one block per 128 rows (two consumer warpgroups) when that gives two
//   blocks per SM, else per 64 rows (one warpgroup, two blocks an SM), so
//   a 256-row B5 shard still fills the card.
//
// Errors: the entries return a cudaError_t, or 10000 + a CUresult when
// cuTensorMapEncodeTiled refuses a tensor map.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;          // K/V (or Q/dO) ring depth
constexpr int kTileBytes = 64 * 128;  // one 64-row x 64-column bf16 box
constexpr float kLog2e = 1.4426950408889634f;

// exp(a - b) as exp2 of (a - b) log2 e.
__device__ __forceinline__ float exp_of_diff(float a, float b) {
  return exp2f((a - b) * kLog2e);
}

struct Geo {
  int Sq, Sk, causal, q_off, k_off;
  float scale;
};

// Number of keys [0, n) that query row r sees (keys visible to a row are a
// prefix: causal masking hides the keys after the diagonal).
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

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a [BH, S, D] bf16 tensor map: 64 columns from c0, the box's
// rows from row, head bh; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(row), "r"(bh)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous product (issued before, completed at wg_wait0).
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void zero_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (>> 4). K-major operands: SBO = 1024 (the next 8
// rows), a 16-column step adds 32 bytes to the start. MN-major operands
// (the transpose bit): SBO = 1024 (the next 8 rows along K), a 16-row step
// adds 2048 bytes; LBO would step to the next 64 columns of N, which an
// n64 product never needs.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32) (+)= A (64 x 16, K-major smem) B (16 x 64, K-major smem)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) B (16 x 64, MN-major smem)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64 x 64 product as the A fragments of four k16
// steps, split in two: hi = bf16(d), lo = bf16(d - hi) (d - hi is exact in
// f32), so that hi + lo carries d to within 2^-16 of its size and a product
// taken as hi x B + lo x B loses nothing to bf16 rounding. Thread (warp
// w, lane l) holds, for column block j (8 columns), d[4j], d[4j+1] at row
// 16w + l/4, columns 8j + 2(l%4) + {0,1}, and d[4j+2], d[4j+3] at row + 8;
// the A fragment of step k takes column blocks 2k and 2k+1 in that order.
__device__ __forceinline__ void to_frags_split(const float (&d)[32],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = d[8 * k + 2 * i], b = d[8 * k + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      hi[k][i] = *reinterpret_cast<const uint32_t*>(&h);
      lo[k][i] = pack_bf16(a - __low2float(h), b - __high2float(h));
    }
}

// Three parts: hi, mid and lo (each remainder exact in f32), which carry d
// to within 2^-24 of its size, as f32 does.
__device__ __forceinline__ void to_frags_split(const float (&d)[32],
                                               uint32_t (&hi)[4][4],
                                               uint32_t (&mid)[4][4],
                                               uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = d[8 * k + 2 * i], b = d[8 * k + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float ra = a - __low2float(h), rb = b - __high2float(h);
      const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
      hi[k][i] = *reinterpret_cast<const uint32_t*>(&h);
      mid[k][i] = *reinterpret_cast<const uint32_t*>(&m);
      lo[k][i] = pack_bf16(ra - __low2float(m), rb - __high2float(m));
    }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s (64 x 64 scores) = A rows of a [rows][64]-box operand x B rows, over D:
// both K-major. a_half / b_half: bytes between the 64-column halves of D.
// The first step overwrites s; callers zero it before their wg_fence all
// the same, so no undefined register reaches the asm.
template <int D>
__device__ __forceinline__ void product_ss(float (&s)[32], uint32_t a,
                                           uint32_t a_half, uint32_t b,
                                           uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(a + (kk / 4) * a_half + off),
             sw128_desc(b + (kk / 4) * b_half + off), kk > 0);
  }
}

// acc[h] += frags (64 x 64 over K) x B (64 rows along K x D, MN-major, the
// 64-column half h at b + h * kTileBytes).
template <int DH>
__device__ __forceinline__ void product_rs(float (&acc)[DH][32],
                                           const uint32_t (&a)[4][4],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < DH; ++h)
      wgmma_rs(acc[h], a[kk], sw128_desc(b + h * kTileBytes + kk * 2048));
}

template <int DH>
__device__ __forceinline__ void fence_acc(float (&acc)[DH][32]) {
#pragma unroll
  for (int h = 0; h < DH; ++h) fence_regs(acc[h]);
}

// x / d, or 0 where d is 0 (a row that saw no key).
__device__ __forceinline__ float div_or_0(float x, float d) {
  return d == 0.f ? 0.f : x / d;
}

// Store a 64-row warpgroup tile acc[h] (with DIVIDE, divided by d0 / d1
// for rows r / r + 8) as bf16 rows [row0, row0 + 8] of a [S, D] matrix,
// rows >= S skipped.
template <int D, bool DIVIDE>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst,
                                           const float (&acc)[D / 64][32],
                                           int row0, int S, float d0,
                                           float d1, int lane) {
  auto f = [](float x, float d) { return DIVIDE ? div_or_0(x, d) : x; };
#pragma unroll
  for (int h = 0; h < D / 64; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * h + 8 * j + 2 * (lane % 4);
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(dst + (long long)row0 * D + col) =
            pack_bf16(f(acc[h][4 * j], d0), f(acc[h][4 * j + 1], d0));
      if (row0 + 8 < S)
        *reinterpret_cast<uint32_t*>(dst + (long long)(row0 + 8) * D + col) =
            pack_bf16(f(acc[h][4 * j + 2], d1), f(acc[h][4 * j + 3], d1));
    }
}

// Zero rows [r0, r1) of a [S, D] bf16 matrix, all threads of the block.
template <int D>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ dst, int r0,
                                          int r1) {
  uint4* p = reinterpret_cast<uint4*>(dst + (long long)r0 * D);
  const int n = (r1 - r0) * D / 8;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

__host__ __device__ constexpr int threads_of(int nc) { return 128 * (nc + 1); }
__host__ __device__ constexpr int blocks_per_sm(int nc) {
  return nc == 1 ? 2 : 1;
}
// registers after the split: the producer warpgroup gives up what the
// consumers take (65536 / threads / blocks per SM at launch)
__host__ __device__ constexpr int producer_regs(int nc) {
  return nc == 1 ? 24 : 40;
}
constexpr int kConsumerRegs = 232;

// ---------------------------------------------------------------- forward

template <int D, int NC>
struct FwdLayout {
  static constexpr int DH = D / 64, BM = 64 * NC;
  static constexpr int Q = 0;                               // DH x [BM][64]
  static constexpr int K = Q + DH * BM * 128;               // stages x DH x [64][64]
  static constexpr int V = K + kStages * DH * kTileBytes;
  static constexpr int BAR = V + kStages * DH * kTileBytes;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * kStages) + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(threads_of(NC), blocks_per_sm(NC))
    fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  bf16* __restrict__ out, float* __restrict__ lse, Geo g) {
  using L = FwdLayout<D, NC>;
  constexpr int DH = L::DH, BM = L::BM;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;     // longest first
  const int q_end = min(q0 + BM, g.Sq);
  const int n_tiles = (keys_seen(g, q_end - 1) + 63) / 64;
  bf16* ob = out + (long long)bh * g.Sq * D;
  float* lb = lse + (long long)bh * g.Sq;
  if (n_tiles == 0) {                // no row sees a key: nothing to load
    zero_rows<D>(ob, q0, q_end);
    for (int i = q0 + threadIdx.x; i < q_end; i += blockDim.x)
      lb[i] = -INFINITY;
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* q_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // ---- producer: one thread issues every TMA load
    setmaxnreg_dec<producer_regs(NC)>();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(q_full, DH * BM * 128);
      for (int h = 0; h < DH; ++h)
        tma_load(sm + L::Q + h * BM * 128, &mq, q_full, 64 * h, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], DH * kTileBytes);
        for (int h = 0; h < DH; ++h)
          tma_load(sm + L::K + (s * DH + h) * kTileBytes, &mk, &k_full[s],
                   64 * h, 64 * t, bh);
        mbar_expect_tx(&v_full[s], DH * kTileBytes);
        for (int h = 0; h < DH; ++h)
          tma_load(sm + L::V + (s * DH + h) * kTileBytes, &mv, &v_full[s],
                   64 * h, 64 * t, bh);
      }
    }
  } else {
    // ---- consumer warpgroup wg: rows [r_lo, r_lo + 64)
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r_lo = q0 + 64 * wg;
    const int row0 = r_lo + 16 * (tid / 32) + lane / 4;   // and row0 + 8
    const bool live = r_lo < g.Sq;
    // tiles this warpgroup computes, and those every row sees whole
    const int n_mine = live ? (keys_seen(g, min(r_lo + 63, g.Sq - 1)) + 63) / 64
                            : 0;
    const int n_whole = live ? keys_seen(g, r_lo) / 64 : 0;
    const int seen0 = keys_seen(g, row0), seen1 = keys_seen(g, row0 + 8);
    const uint32_t a_q = smem_u32(sm + L::Q) + wg * 64 * 128;

    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    float o[DH][32];
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[h][i] = 0.f;

    if (n_mine > 0) mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      mbar_wait(&k_full[s], ph);
      if (t < n_mine) {
        float sc[32];
        zero_regs(sc);
        wg_fence();
        product_ss<D>(sc, a_q, BM * 128,
                      smem_u32(sm + L::K + s * DH * kTileBytes), kTileBytes);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        // scaled scores, masked
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= g.scale;
        if (t >= n_whole) {
          const int b0 = seen0 - 64 * t, b1 = seen1 - 64 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + 2 * (lane % 4) + e;
              if (col >= b0) sc[4 * j + e] = -INFINITY;
              if (col >= b1) sc[4 * j + 2 + e] = -INFINITY;
            }
        }
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
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
          sc[4 * j] = exp_of_diff(sc[4 * j], u0);
          sc[4 * j + 1] = exp_of_diff(sc[4 * j + 1], u0);
          sc[4 * j + 2] = exp_of_diff(sc[4 * j + 2], u1);
          sc[4 * j + 3] = exp_of_diff(sc[4 * j + 3], u1);
          s0 += sc[4 * j] + sc[4 * j + 1];
          s1 += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l0 = l0 * corr0 + quad_sum(s0);
        l1 = l1 * corr1 + quad_sum(s1);
        // acc = acc corr + p V, p as its three bf16 parts (three products)
        uint32_t p_hi[4][4], p_mid[4][4], p_lo[4][4];
        to_frags_split(sc, p_hi, p_mid, p_lo);
#pragma unroll
        for (int h = 0; h < DH; ++h)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            o[h][4 * j] *= corr0;
            o[h][4 * j + 1] *= corr0;
            o[h][4 * j + 2] *= corr1;
            o[h][4 * j + 3] *= corr1;
          }
        const uint32_t bv = smem_u32(sm + L::V + s * DH * kTileBytes);
        mbar_wait(&v_full[s], ph);
        fence_acc<DH>(o);
        wg_fence();
        product_rs<DH>(o, p_hi, bv);
        product_rs<DH>(o, p_mid, bv);
        product_rs<DH>(o, p_lo, bv);
        wg_commit();
        wg_wait0();
        fence_acc<DH>(o);
        fence_regs(p_hi);
        fence_regs(p_mid);
        fence_regs(p_lo);
      } else {
        mbar_wait(&v_full[s], ph);
      }
      mbar_arrive(&empty[s]);
    }

    store_rows<D, true>(ob, o, row0, g.Sq, l0, l1, lane);
    if (lane % 4 == 0) {
      if (row0 < g.Sq)
        lb[row0] = l0 == 0.f ? -INFINITY : m0 + logf(l0);
      if (row0 + 8 < g.Sq)
        lb[row0 + 8] = l1 == 0.f ? -INFINITY : m1 + logf(l1);
    }
  }
}

// ------------------------------------------------------- backward: dQ pass

template <int D, int NC>
struct DqLayout {
  static constexpr int DH = D / 64, BM = 64 * NC;
  static constexpr int Q = 0;                               // DH x [BM][64]
  static constexpr int DO = Q + DH * BM * 128;
  static constexpr int K = DO + DH * BM * 128;              // stages x DH x [64][64]
  static constexpr int V = K + kStages * DH * kTileBytes;
  static constexpr int DELTA = V + kStages * DH * kTileBytes;   // [BM] f32
  static constexpr int BAR = DELTA + 4 * BM;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * kStages) + 1024;
};

// Part of delta = rowsum(dO * O) of one row, columns [d0, d0 + n), read
// from global memory (f32).
__device__ __forceinline__ float row_delta(const bf16* __restrict__ o,
                                           const bf16* __restrict__ dout,
                                           int d0, int n) {
  float acc = 0.f;
  for (int d = d0; d < d0 + n; d += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + d);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + d);
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(pa[i]), fb = __bfloat1622float2(pb[i]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  return acc;
}

// DELTA_IN false (B1): delta = rowsum(dO * O) here, stored for the dK/dV
// pass. DELTA_IN true (B5): delta is an input, o is not read.
template <int D, int NC, bool DELTA_IN>
__global__ void __launch_bounds__(threads_of(NC), blocks_per_sm(NC))
    dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const bf16* __restrict__ o, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 bf16* __restrict__ dq, Geo g) {
  using L = DqLayout<D, NC>;
  constexpr int DH = L::DH, BM = L::BM;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const int q_end = min(q0 + BM, g.Sq);
  const int n_tiles = (keys_seen(g, q_end - 1) + 63) / 64;
  const long long qoff = (long long)bh * g.Sq * D;
  float* db = delta + (long long)bh * g.Sq;
  if (n_tiles == 0) {                // no row sees a key: dq = 0
    zero_rows<D>(dq + qoff, q0, q_end);
    if constexpr (!DELTA_IN)
      for (int r = q0 + threadIdx.x; r < q_end; r += blockDim.x)
        db[r] = row_delta(o + qoff + (long long)r * D,
                          dout + qoff + (long long)r * D, 0, D);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* qd_full = bar;
  uint64_t* k_full = bar + 1;
  uint64_t* v_full = bar + 1 + kStages;
  uint64_t* empty = bar + 1 + 2 * kStages;
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    setmaxnreg_dec<producer_regs(NC)>();
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(qd_full, 2 * DH * BM * 128);
      for (int h = 0; h < DH; ++h) {
        tma_load(sm + L::Q + h * BM * 128, &mq, qd_full, 64 * h, q0, bh);
        tma_load(sm + L::DO + h * BM * 128, &mdo, qd_full, 64 * h, q0, bh);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], DH * kTileBytes);
        for (int h = 0; h < DH; ++h)
          tma_load(sm + L::K + (s * DH + h) * kTileBytes, &mk, &k_full[s],
                   64 * h, 64 * t, bh);
        mbar_expect_tx(&v_full[s], DH * kTileBytes);
        for (int h = 0; h < DH; ++h)
          tma_load(sm + L::V + (s * DH + h) * kTileBytes, &mv, &v_full[s],
                   64 * h, 64 * t, bh);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int r_lo = q0 + 64 * wg;
    const int row0 = r_lo + 16 * (tid / 32) + lane / 4;
    const bool live = r_lo < g.Sq;
    const int n_mine = live ? (keys_seen(g, min(r_lo + 63, g.Sq - 1)) + 63) / 64
                            : 0;
    const int n_whole = live ? keys_seen(g, r_lo) / 64 : 0;
    const int seen0 = keys_seen(g, row0), seen1 = keys_seen(g, row0 + 8);

    // this thread's rows: lse (-inf, or a row past Sq: +inf, so p = 0)
    // and delta
    const float* lsb = lse + (long long)bh * g.Sq;
    float ls0 = row0 < g.Sq ? lsb[row0] : INFINITY;
    float ls1 = row0 + 8 < g.Sq ? lsb[row0 + 8] : INFINITY;
    if (ls0 == -INFINITY) ls0 = INFINITY;
    if (ls1 == -INFINITY) ls1 = INFINITY;
    float dl0, dl1;
    if constexpr (DELTA_IN) {
      dl0 = row0 < g.Sq ? db[row0] : 0.f;
      dl1 = row0 + 8 < g.Sq ? db[row0 + 8] : 0.f;
    } else {
      // two threads a row, half of D each
      float* dsm = reinterpret_cast<float*>(sm + L::DELTA) + 64 * wg;
      const int r = r_lo + tid / 2;
      float part = 0.f;
      if (r < g.Sq)
        part = row_delta(o + qoff + (long long)r * D,
                         dout + qoff + (long long)r * D, (tid % 2) * D / 2,
                         D / 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (tid % 2 == 0) {
        dsm[tid / 2] = part;
        if (r < g.Sq) db[r] = part;
      }
      named_sync(1 + wg, 128);
      dl0 = dsm[row0 - r_lo];
      dl1 = dsm[row0 + 8 - r_lo];
    }

    float acc[DH][32];
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    const uint32_t a_q = smem_u32(sm + L::Q) + wg * 64 * 128;
    const uint32_t a_do = smem_u32(sm + L::DO) + wg * 64 * 128;

    if (n_mine > 0) mbar_wait(qd_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const uint32_t ph = (t / kStages) & 1;
      mbar_wait(&k_full[s], ph);
      mbar_wait(&v_full[s], ph);
      if (t < n_mine) {
        const uint32_t bk = smem_u32(sm + L::K + s * DH * kTileBytes);
        float sc[32], dp[32];
        zero_regs(sc);
        zero_regs(dp);
        wg_fence();
        product_ss<D>(sc, a_q, BM * 128, bk, kTileBytes);
        product_ss<D>(dp, a_do, BM * 128,
                      smem_u32(sm + L::V + s * DH * kTileBytes), kTileBytes);
        wg_commit();
        wg_wait0();
        fence_regs(sc);
        fence_regs(dp);
        const bool whole = t < n_whole;
        const int b0 = seen0 - 64 * t, b1 = seen1 - 64 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * j + 2 * (lane % 4) + e;
            const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
            const float p0 =
                (whole || col < b0)
                    ? exp_of_diff(sc[i0] * g.scale, ls0) : 0.f;
            const float p1 =
                (whole || col < b1)
                    ? exp_of_diff(sc[i1] * g.scale, ls1) : 0.f;
            dp[i0] = p0 * (dp[i0] - dl0) * g.scale;
            dp[i1] = p1 * (dp[i1] - dl1) * g.scale;
          }
        uint32_t dh[4][4], dl[4][4];
        to_frags_split(dp, dh, dl);
        fence_acc<DH>(acc);
        wg_fence();
        product_rs<DH>(acc, dh, bk);
        product_rs<DH>(acc, dl, bk);
        wg_commit();
        wg_wait0();
        fence_acc<DH>(acc);
        fence_regs(dh);
        fence_regs(dl);
      }
      mbar_arrive(&empty[s]);
    }
    store_rows<D, false>(dq + qoff, acc, row0, g.Sq, 0.f, 0.f, lane);
  }
}

// --------------------------------------------------- backward: dK/dV pass

template <int D, int NC>
struct DkvLayout {
  static constexpr int DH = D / 64, BN = 64 * NC;
  static constexpr int K = 0;                               // DH x [BN][64]
  static constexpr int V = K + DH * BN * 128;
  static constexpr int Q = V + DH * BN * 128;               // stages x DH x [64][64]
  static constexpr int DO = Q + kStages * DH * kTileBytes;
  static constexpr int LSE = DO + kStages * DH * kTileBytes;  // stages x [64] f32
  static constexpr int DELTA = LSE + kStages * 256;
  static constexpr int BAR = DELTA + kStages * 256;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * kStages) + 1024;
};

template <int D, int NC>
__global__ void __launch_bounds__(threads_of(NC), blocks_per_sm(NC))
    dkv_tc_kernel(const __grid_constant__ CUtensorMap mq,
                  const __grid_constant__ CUtensorMap mk,
                  const __grid_constant__ CUtensorMap mv,
                  const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, Geo g) {
  using L = DkvLayout<D, NC>;
  constexpr int DH = L::DH, BN = L::BN;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;             // the first keys see the most
  const int k_end = min(k0 + BN, g.Sk);
  const int fq = first_query(g, k0);
  const int qt_lo = fq / 64;
  const int n_tiles = fq < g.Sq ? (g.Sq + 63) / 64 - qt_lo : 0;
  const long long koff = (long long)bh * g.Sk * D;
  if (n_tiles == 0) {                // no query sees a key: zero grads
    zero_rows<D>(dk + koff, k0, k_end);
    zero_rows<D>(dv + koff, k0, k_end);
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* kv_full = bar;
  uint64_t* full = bar + 1;
  uint64_t* empty = bar + 1 + kStages;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA's expect_tx + 32 lanes' rows
      mbar_init(&empty[s], NC * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const long long rows = (long long)bh * g.Sq;
  if (wg == NC) {
    // ---- producer warp: lane 0 issues the TMA loads, every lane copies
    // lse and delta of its two rows (+inf / 0 past Sq; lse -inf as +inf)
    setmaxnreg_dec<producer_regs(NC)>();
    const int lane = threadIdx.x % 32;
    if ((threadIdx.x % 128) / 32 == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * DH * BN * 128);
        for (int h = 0; h < DH; ++h) {
          tma_load(sm + L::K + h * BN * 128, &mk, kv_full, 64 * h, k0, bh);
          tma_load(sm + L::V + h * BN * 128, &mv, kv_full, 64 * h, k0, bh);
        }
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int qt0 = (qt_lo + t) * 64;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * DH * kTileBytes);
          for (int h = 0; h < DH; ++h) {
            tma_load(sm + L::Q + (s * DH + h) * kTileBytes, &mq, &full[s],
                     64 * h, qt0, bh);
            tma_load(sm + L::DO + (s * DH + h) * kTileBytes, &mdo, &full[s],
                     64 * h, qt0, bh);
          }
        }
        float* ls = reinterpret_cast<float*>(sm + L::LSE) + 64 * s;
        float* ds = reinterpret_cast<float*>(sm + L::DELTA) + 64 * s;
        for (int i = lane; i < 64; i += 32) {
          const int r = qt0 + i;
          float x = r < g.Sq ? lse[rows + r] : INFINITY;
          ls[i] = x == -INFINITY ? INFINITY : x;
          ds[i] = r < g.Sq ? delta[rows + r] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, lane = tid % 32;
    const int kc = k0 + 64 * wg;                      // this warpgroup's keys
    const int krow0 = kc + 16 * (tid / 32) + lane / 4;  // and krow0 + 8
    const bool live = kc < g.Sk;
    // q tiles below t_lo see none of these keys; from t_whole on, every
    // query of a tile sees every key
    const int t_lo = live ? first_query(g, kc) / 64 : 1 << 30;
    const int t_whole =
        live ? (first_query(g, min(kc + 63, g.Sk - 1)) + 63) / 64 : 1 << 30;
    const int fq0 = first_query(g, krow0), fq1 = first_query(g, krow0 + 8);
    const uint32_t a_k = smem_u32(sm + L::K) + wg * 64 * 128;
    const uint32_t a_v = smem_u32(sm + L::V) + wg * 64 * 128;

    float adk[DH][32], adv[DH][32];
#pragma unroll
    for (int h = 0; h < DH; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) adk[h][i] = adv[h][i] = 0.f;

    if (live) mbar_wait(kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int ta = qt_lo + t;
      mbar_wait(&full[s], (t / kStages) & 1);
      if (ta >= t_lo) {
        const uint32_t bq = smem_u32(sm + L::Q + s * DH * kTileBytes);
        const uint32_t bdo = smem_u32(sm + L::DO + s * DH * kTileBytes);
        float st[32], dpt[32];
        zero_regs(st);
        zero_regs(dpt);
        wg_fence();
        product_ss<D>(st, a_k, BN * 128, bq, kTileBytes);
        product_ss<D>(dpt, a_v, BN * 128, bdo, kTileBytes);
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dpt);
        const float* ls = reinterpret_cast<const float*>(sm + L::LSE) + 64 * s;
        const float* dls = reinterpret_cast<const float*>(sm + L::DELTA) + 64 * s;
        const bool whole = ta >= t_whole;
        const int b0 = fq0 - 64 * ta, b1 = fq1 - 64 * ta;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * (lane % 4);
          const float2 lq = *reinterpret_cast<const float2*>(ls + col);
          const float2 dq2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float lc = e ? lq.y : lq.x, dc = e ? dq2.y : dq2.x;
            const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
            const float p0 =
                (whole || col + e >= b0)
                    ? exp_of_diff(st[i0] * g.scale, lc) : 0.f;
            const float p1 =
                (whole || col + e >= b1)
                    ? exp_of_diff(st[i1] * g.scale, lc) : 0.f;
            st[i0] = p0;
            st[i1] = p1;
            dpt[i0] = p0 * (dpt[i0] - dc) * g.scale;
            dpt[i1] = p1 * (dpt[i1] - dc) * g.scale;
          }
        }
        uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
        to_frags_split(st, ph, pl);
        to_frags_split(dpt, dh, dl);
        fence_acc<DH>(adv);
        fence_acc<DH>(adk);
        wg_fence();
        product_rs<DH>(adv, ph, bdo);
        product_rs<DH>(adv, pl, bdo);
        product_rs<DH>(adk, dh, bq);
        product_rs<DH>(adk, dl, bq);
        wg_commit();
        wg_wait0();
        fence_acc<DH>(adv);
        fence_acc<DH>(adk);
        fence_regs(ph);
        fence_regs(pl);
        fence_regs(dh);
        fence_regs(dl);
      }
      mbar_arrive(&empty[s]);
    }
    store_rows<D, false>(dk + koff, adk, krow0, g.Sk, 0.f, 0.f, lane);
    store_rows<D, false>(dv + koff, adv, krow0, g.Sk, 0.f, 0.f, lane);
  }
}

// ------------------------------------------- a block that no query sees

// Its gradients are zero: dq (na 16-byte words), dk and dv (nb each) in one
// launch that reads nothing.
__global__ void __launch_bounds__(256)
    zero_grads_kernel(uint4* __restrict__ dq, long long na,
                      uint4* __restrict__ dk, uint4* __restrict__ dv,
                      long long nb) {
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no
// -lcuda; looked up once.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [BH, S, D] bf16, boxes of 64 columns x `rows` rows x 1 head, 128-byte
// swizzle, zeros outside. 0, or the error to return.
int make_map(CUtensorMap* m, const void* base, int BH, int S, int D,
             int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

// Two consumer warpgroups (128 rows) a block when that still gives two
// blocks an SM, else one (64 rows).
int pick_nc(int BH, int S) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return (long long)BH * ((S + 127) / 128) >= 2LL * sms ? 2 : 1;
}

template <typename K>
cudaError_t prepare(K kern, int smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int D, int NC>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int BH, const Geo& g, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = make_map(&mq, q, BH, g.Sq, D, 64 * NC)) ||
      (rc = make_map(&mk, k, BH, g.Sk, D, 64)) ||
      (rc = make_map(&mv, v, BH, g.Sk, D, 64)))
    return rc;
  auto kern = fwd_tc_kernel<D, NC>;
  constexpr int smem = FwdLayout<D, NC>::BYTES;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (g.Sq + 64 * NC - 1) / (64 * NC));
  kern<<<grid, threads_of(NC), smem, st>>>(mq, mk, mv, static_cast<bf16*>(out),
                                           static_cast<float*>(lse), g);
  return (int)cudaGetLastError();
}

template <int D, int NC, bool DELTA_IN>
int dq_pass(const CUtensorMap& mq, const CUtensorMap& mdo, const void* k,
            const void* v, const void* o, const void* dout, const void* lse,
            void* delta, void* dq, int BH, const Geo& g, cudaStream_t st) {
  CUtensorMap mk, mv;
  int rc;
  if ((rc = make_map(&mk, k, BH, g.Sk, D, 64)) ||
      (rc = make_map(&mv, v, BH, g.Sk, D, 64)))
    return rc;
  auto kern = dq_tc_kernel<D, NC, DELTA_IN>;
  constexpr int smem = DqLayout<D, NC>::BYTES;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (g.Sq + 64 * NC - 1) / (64 * NC));
  kern<<<grid, threads_of(NC), smem, st>>>(
      mq, mk, mv, mdo, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), g);
  return (int)cudaGetLastError();
}

template <int D, int NC>
int dkv_pass(const void* q, const CUtensorMap& mk, const CUtensorMap& mv,
             const void* dout, const void* lse, const void* delta, void* dk,
             void* dv, int BH, const Geo& g, cudaStream_t st) {
  CUtensorMap mq, mdo;
  int rc;
  if ((rc = make_map(&mq, q, BH, g.Sq, D, 64)) ||
      (rc = make_map(&mdo, dout, BH, g.Sq, D, 64)))
    return rc;
  auto kern = dkv_tc_kernel<D, NC>;
  constexpr int smem = DkvLayout<D, NC>::BYTES;
  cudaError_t e = prepare(kern, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (g.Sk + 64 * NC - 1) / (64 * NC));
  kern<<<grid, threads_of(NC), smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), g);
  return (int)cudaGetLastError();
}

// The dQ pass (which, without DELTA_IN, writes delta), then the dK/dV pass
// on the same stream.
template <int D, bool DELTA_IN>
int bwd(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int BH, const Geo& g, cudaStream_t st) {
  const int ncq = pick_nc(BH, g.Sq), nck = pick_nc(BH, g.Sk);
  CUtensorMap mq, mdo, mk, mv;
  int rc;
  if ((rc = make_map(&mq, q, BH, g.Sq, D, 64 * ncq)) ||
      (rc = make_map(&mdo, dout, BH, g.Sq, D, 64 * ncq)) ||
      (rc = make_map(&mk, k, BH, g.Sk, D, 64 * nck)) ||
      (rc = make_map(&mv, v, BH, g.Sk, D, 64 * nck)))
    return rc;
  rc = ncq == 2 ? dq_pass<D, 2, DELTA_IN>(mq, mdo, k, v, o, dout, lse, delta,
                                         dq, BH, g, st)
                : dq_pass<D, 1, DELTA_IN>(mq, mdo, k, v, o, dout, lse, delta,
                                         dq, BH, g, st);
  if (rc) return rc;
  return nck == 2 ? dkv_pass<D, 2>(q, mk, mv, dout, lse, delta, dk, dv, BH, g,
                                  st)
                  : dkv_pass<D, 1>(q, mk, mv, dout, lse, delta, dk, dv, BH, g,
                                  st);
}

bool geo_ok(int BH, int Sq, int Sk, int D, int is_bf16) {
  return is_bf16 == 1 && BH >= 1 && BH <= 65535 && Sq >= 1 && Sk >= 1 &&
         (D == 64 || D == 128);
}

template <bool DELTA_IN>
int bwd_any(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* delta, void* dq, void* dk,
            void* dv, int BH, const Geo& g, int D, cudaStream_t st) {
  return D == 64 ? bwd<64, DELTA_IN>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     BH, g, st)
                 : bwd<128, DELTA_IN>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, BH, g, st);
}

}  // namespace

// q [BH, Sq, D], k/v [BH, Sk, D], out [BH, Sq, D] contiguous bf16
// (is_bf16 must be 1), 16-byte aligned, D 64 or 128; lse [BH, Sq] f32 out.
extern "C" int flash_fwd_tc_launch(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int BH, int Sq,
                                   int Sk, int D, int causal, int q_off,
                                   int k_off, float scale, int is_bf16,
                                   void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = pick_nc(BH, Sq);
  if (D == 64)
    return nc == 2 ? fwd<64, 2>(q, k, v, out, lse, BH, g, st)
                   : fwd<64, 1>(q, k, v, out, lse, BH, g, st);
  return nc == 2 ? fwd<128, 2>(q, k, v, out, lse, BH, g, st)
                 : fwd<128, 1>(q, k, v, out, lse, BH, g, st);
}

// The same layouts; o / dout [BH, Sq, D]; lse [BH, Sq] f32 from the
// forward; delta [BH, Sq] f32 scratch; dq [BH, Sq, D], dk / dv [BH, Sk, D]
// out. Two launches: dQ (+ delta), then dK/dV.
extern "C" int flash_bwd_tc_launch(const void* q, const void* k, const void* v,
                                   const void* o, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int BH, int Sq, int Sk,
                                   int D, int causal, int q_off, int k_off,
                                   float scale, int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  return bwd_any<false>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, g, D,
                        static_cast<cudaStream_t>(stream));
}

// B5's backward: the same without O; lse and delta [BH, Sq] f32 are the
// caller's (global residuals of a ring, or of one block with any lse
// cotangent folded into delta) and are only read. Two launches.
extern "C" int flash_block_bwd_tc_launch(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dq, void* dk, void* dv, int BH,
                                         int Sq, int Sk, int D, int causal,
                                         int q_off, int k_off, float scale,
                                         int is_bf16, void* stream) {
  if (!geo_ok(BH, Sq, Sk, D, is_bf16)) return (int)cudaErrorInvalidValue;
  const Geo g{Sq, Sk, causal, q_off, k_off, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (causal && (long long)q_off + Sq - 1 < k_off) {
    // a block wholly in the causal future (a ring's): zero grads, one
    // launch, nothing read
    const long long na = (long long)BH * Sq * D / 8, nb = (long long)BH * Sk * D / 8;
    const long long blocks = ((na > nb ? na : nb) + 255) / 256;
    zero_grads_kernel<<<(int)(blocks < 1056 ? blocks : 1056), 256, 0, st>>>(
        static_cast<uint4*>(dq), na, static_cast<uint4*>(dk),
        static_cast<uint4*>(dv), nb);
    return (int)cudaGetLastError();
  }
  // DELTA_IN never writes delta: the const_cast only fits the shared
  // kernel signature
  return bwd_any<true>(q, k, v, nullptr, dout, lse, const_cast<void*>(delta),
                       dq, dk, dv, BH, g, D, st);
}

// Dynamic shared memory (bytes) a kernel asks for: pass 0 forward, 1 dQ,
// 2 dK/dV; nc consumer warpgroups; -1 for another shape.
extern "C" int flash_tc_smem_bytes(int pass, int D, int nc) {
  if ((D != 64 && D != 128) || (nc != 1 && nc != 2)) return -1;
#define SMEM_OF(L)                                                         \
  (D == 64 ? (nc == 1 ? L<64, 1>::BYTES : L<64, 2>::BYTES)                 \
           : (nc == 1 ? L<128, 1>::BYTES : L<128, 2>::BYTES))
  switch (pass) {
    case 0: return SMEM_OF(FwdLayout);
    case 1: return SMEM_OF(DqLayout);
    case 2: return SMEM_OF(DkvLayout);
    default: return -1;
  }
#undef SMEM_OF
}
