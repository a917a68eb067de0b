// KV-cache writes for Hopper (sm_90a): the slot form and the paged form.
//
// Slot form, cache[b, pos[b]] = rows[b, 0], up to four planes in one
// launch (kv_slot_write_launch): replaces the TPU kernel
// paddle_tpu/kernels/cache_write.py:fused_slot_write (bodies
// _slot_kernel_row / _slot_kernel_whole), which the int8 slot decode calls
// four times a layer (k data, k scale, v data, v scale). Each plane is a
// cache [B, L, ...] and its rows [B, 1, ...] of the same type (int8 data
// [B, L, nkv, hd], its f32 scale plane [B, L, nkv], or f32/bf16 data), all
// planes sharing B, L and pos [B] int32; a row whose position lies outside
// [0, L) writes nothing, as the TPU kernel's select writes nothing there.
// The planes travel in one struct by value; the grid is (unit of a row,
// plane), each thread copying 16, 8, 4, 2 or 1 bytes as the plane's row
// length and pointers allow. The rows come pre-quantised: the int8 decode
// merges the new row through its quantise -> dequantise round trip before
// the write, so it quantises once and hands the same rows here.
//
// Paged form, both cache halves of a layer in one launch
// (kv_paged_write_launch): replaces the per-half calls of
// paddle_tpu/kernels/cache_write.py:fused_paged_write (bodies
// _paged_kernel_whole / _paged_kernel_page) together with the index and
// quantisation arithmetic around them in paddle_tpu's
// nn/functional/flash_attention.py:_paged_cache_write. For every half h
// (k, v), batch row b, incoming row s and kv head: t = base[b] + s (base a
// scalar or pos[b]); the row writes where t < PM * PS, live[b] (when given)
// and s < wlen (when given), at physical page phys = bt[b, clamp(floor(t /
// PS), 0, PM - 1)] and offset floor-mod(t, PS), and only where 0 <= phys <
// NP, as the TPU kernel's page programs match no other row. Floor division
// and floor-mod put a negative t where paddle_tpu puts it (page slot 0,
// offset t mod PS). The source rows are the strided [B, S, nkv, hd] views
// the qkv projection gives (row, step and head strides; innermost stride
// 1), f32 or bf16; the pool halves [NP, PS, nkv, hd] are f32, bf16 (f32
// rows rounded to nearest even by __float2bfloat16_rn, as Tensor.to) or
// int8 with an f32 [NP, PS, nkv] scale plane. For int8 the launch
// quantises each (row, head) itself: amax over hd by a shuffle reduction
// on the bit patterns of |x| (so a NaN, whose pattern is above every
// finite one and inf, propagates as torch.amax and torch.clamp propagate
// it), scale = amax / 127 and q = rint(x / max(scale, 1e-12)) in IEEE
// division, round half to even, cast as Tensor.to(int8) casts. Valid rows
// target distinct (page, offset) pairs (the caller's copy-on-write
// invariant); where two collide, which one lands is unspecified here.
//
// Paged form, one half from precomputed indices (paged_write_launch):
// pages[phys[i], off[i]] = rows[i] where valid[i] != 0, 0 <= phys[i] < NP
// and 0 <= off[i] < PS; the per-plane counterpart of fused_paged_write,
// kept beside the fused launch.
//
// What bounds them on this card: launch latency. The TPU kernels stream a
// whole block (a slot's [1, L, ...] row, or each pool page) through VMEM
// and leave the index and quantisation arithmetic to the XLA program
// around them, which is one program on the TPU; on this card every op of
// that arithmetic is a launch of its own. These kernels touch only the new
// rows (a few KB at decode, under 2 MB at admission), so each costs what a
// launch costs, and the design is about the number of launches: one a layer
// for the paged form, both halves and every leaf included, with the one
// dependent load (bt[b, page slot]) inside it, and each lane's first chunk
// of its row loaded before that chain so the two trips to memory overlap;
// one a layer for the int8 slot planes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ----------------------------------------------------------- slot form

constexpr int kMaxPlanes = 4;

struct SlotPlane {
  char* dst;            // [B, L, row_bytes]
  const char* src;      // [B, 1, row_bytes]
  long long row_bytes;  // bytes of one position's row (inner x element size)
  int unit;             // bytes a thread copies: 16, 8, 4, 2 or 1
};

struct SlotPlanes {
  SlotPlane p[kMaxPlanes];
};

template <typename U>
__device__ __forceinline__ void copy_unit(char* dst, const char* src) {
  *reinterpret_cast<U*>(dst) = *reinterpret_cast<const U*>(src);
}

__global__ void slot_write_kernel(const __grid_constant__ SlotPlanes planes,
                                  const int* __restrict__ pos, int B, int L) {
  const SlotPlane& pl = planes.p[blockIdx.y];
  const long long units = pl.row_bytes / pl.unit;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * units) return;
  const int b = (int)(idx / units);
  const int p = pos[b];
  if (p < 0 || p >= L) return;
  const long long at = (idx - (long long)b * units) * pl.unit;
  char* dst = pl.dst + ((long long)b * L + p) * pl.row_bytes + at;
  const char* src = pl.src + (long long)b * pl.row_bytes + at;
  switch (pl.unit) {
    case 16: copy_unit<uint4>(dst, src); break;
    case 8: copy_unit<uint2>(dst, src); break;
    case 4: copy_unit<uint32_t>(dst, src); break;
    case 2: copy_unit<uint16_t>(dst, src); break;
    default: *dst = *src; break;
  }
}

// ---------------------------------------------------------- paged form

struct PagedHalf {
  const void* src;       // [B, S, nkv, hd] view, innermost stride 1
  long long sb, ss, sh;  // element strides of the row, step and head
  void* pages;           // [NP, PS, nkv, hd] contiguous
  float* scale;          // [NP, PS, nkv] contiguous (int8 pools), else null
};

struct PagedArgs {
  PagedHalf half[2];
  const long long* bt;   // [B, PM] int64, row stride bt_stride
  long long bt_stride;
  const int* pos;        // [B] int32 per-row positions, or null: pos0
  long long pos0;
  const bool* live;      // [B] write gate, or null
  long long wlen;        // only incoming rows s < wlen write; -1: all
  int halves, B, S, nkv, hd, NP, PS, PM;
  int group;             // lanes per (half, b, s, head): a power of 2 <= 32
};

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename D>
__device__ __forceinline__ D cast_to(float x);
template <>
__device__ __forceinline__ float cast_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// bf16 rows into a bf16 pool are copied bit for bit
template <typename D, typename S>
__device__ __forceinline__ D convert(S x) { return cast_to<D>(to_f32(x)); }
template <>
__device__ __forceinline__ __nv_bfloat16
convert<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 x) {
  return x;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One group of `group` lanes per (half, b, s, head); each lane moves
// chunks of VEC elements (lane, lane + group, ...). Src: float or bf16;
// Dst: float, bf16, or int8 (quantised in the launch).
template <typename Src, typename Dst, int VEC>
__global__ void __launch_bounds__(kThreads)
kv_paged_write_kernel(const __grid_constant__ PagedArgs a) {
  constexpr bool kQuant = sizeof(Dst) == 1;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long item = gid / a.group;
  const int lane = (int)(gid & (a.group - 1));
  const long long items = (long long)a.halves * a.B * a.S * a.nkv;
  const int chunks = a.hd / VEC;
  bool ok = item < items;
  int h = 0, s = 0, b = 0, hf = 0;
  if (ok) {
    long long r = item;
    h = (int)(r % a.nkv);
    r /= a.nkv;
    s = (int)(r % a.S);
    r /= a.S;
    b = (int)(r % a.B);
    hf = (int)(r / a.B);
  }
  const PagedHalf& H = a.half[hf];
  const Src* src = static_cast<const Src*>(H.src) + b * H.sb + s * H.ss +
                   h * H.sh;
  // the lane's first chunk is loaded before the index chain (pos, then
  // bt[b, page slot]), so that the row's trip to memory overlaps it
  Pack<Src, VEC> first;
  if (ok && lane < chunks)
    first = *reinterpret_cast<const Pack<Src, VEC>*>(src + lane * VEC);
  auto chunk = [&](int c) {
    return c == lane ? first
                     : *reinterpret_cast<const Pack<Src, VEC>*>(src + c * VEC);
  };
  long long phys = 0, off = 0;
  if (ok) {
    const long long t = (a.pos ? (long long)a.pos[b] : a.pos0) + s;
    ok = t < (long long)a.PM * a.PS && (a.live == nullptr || a.live[b]) &&
         (a.wlen < 0 || s < a.wlen);
    if (ok) {
      const long long q = floor_div(t, a.PS);
      const long long slot = q < 0 ? 0 : (q > a.PM - 1 ? a.PM - 1 : q);
      phys = a.bt[(long long)b * a.bt_stride + slot];
      off = t - q * a.PS;
      ok = phys >= 0 && phys < a.NP;
    }
  }
  if (!kQuant && !ok) return;
  const long long dst_row = (phys * a.PS + off) * a.nkv + h;
  Dst* dst = static_cast<Dst*>(H.pages) + dst_row * a.hd;
  if constexpr (!kQuant) {
    for (int c = lane; c < chunks; c += a.group) {
      const Pack<Src, VEC> in = chunk(c);
      Pack<Dst, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) out.v[i] = convert<Dst>(in.v[i]);
      *reinterpret_cast<Pack<Dst, VEC>*>(dst + c * VEC) = out;
    }
  } else {
    // every lane of the warp reaches the shuffles; a lane without a row to
    // write contributes 0 (its group's result is never stored)
    unsigned m = 0;
    if (ok) {
      for (int c = lane; c < chunks; c += a.group) {
        const Pack<Src, VEC> in = chunk(c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const unsigned u = __float_as_uint(to_f32(in.v[i])) & 0x7fffffffu;
          m = u > m ? u : m;
        }
      }
    }
    for (int o = a.group >> 1; o > 0; o >>= 1) {
      const unsigned u = __shfl_xor_sync(0xffffffffu, m, o);
      m = u > m ? u : m;
    }
    if (!ok) return;
    const float scale = __fdiv_rn(__uint_as_float(m), 127.0f);
    const float d = scale < 1e-12f ? 1e-12f : scale;   // NaN stays NaN
    if (lane == 0) H.scale[dst_row] = scale;
    for (int c = lane; c < chunks; c += a.group) {
      const Pack<Src, VEC> in = chunk(c);
      Pack<int8_t, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        out.v[i] = static_cast<int8_t>(rintf(__fdiv_rn(to_f32(in.v[i]), d)));
      *reinterpret_cast<Pack<int8_t, VEC>*>(dst + c * VEC) = out;
    }
  }
}

template <typename Src, typename Dst, int VEC>
cudaError_t launch_kv_paged(const PagedArgs& a, cudaStream_t stream) {
  const long long threads =
      (long long)a.halves * a.B * a.S * a.nkv * a.group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  kv_paged_write_kernel<Src, Dst, VEC>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename Src, typename Dst>
cudaError_t launch_kv_paged_vec(const PagedArgs& a, int vec,
                                cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_kv_paged<Src, Dst, 1>(a, stream);
    case 2: return launch_kv_paged<Src, Dst, 2>(a, stream);
    case 4: return launch_kv_paged<Src, Dst, 4>(a, stream);
    case 8:
      if constexpr (sizeof(Dst) <= 2)
        return launch_kv_paged<Src, Dst, 8>(a, stream);
      break;
    case 16:
      if constexpr (sizeof(Dst) == 1)
        return launch_kv_paged<Src, Dst, 16>(a, stream);
      break;
  }
  return cudaErrorInvalidValue;
}

template <typename Src>
cudaError_t launch_kv_paged_dst(const PagedArgs& a, int dst_code, int vec,
                                cudaStream_t stream) {
  switch (dst_code) {
    case 0: return launch_kv_paged_vec<Src, float>(a, vec, stream);
    case 1: return launch_kv_paged_vec<Src, __nv_bfloat16>(a, vec, stream);
    case 2: return launch_kv_paged_vec<Src, int8_t>(a, vec, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
__global__ void paged_write_kernel(T* __restrict__ pages,
                                   const T* __restrict__ rows,
                                   const int* __restrict__ phys,
                                   const int* __restrict__ off,
                                   const int* __restrict__ valid, int n,
                                   int NP, int PS, long long inner) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n * inner) return;
  const int i = (int)(idx / inner);
  if (valid[i] == 0) return;
  const int p = phys[i];
  const int o = off[i];
  if (p < 0 || p >= NP || o < 0 || o >= PS) return;
  const long long e = idx - (long long)i * inner;
  pages[((long long)p * PS + o) * inner + e] = rows[idx];
}

template <typename T>
cudaError_t launch_paged(void* pages, const void* rows, const int* phys,
                         const int* off, const int* valid, int n, int NP,
                         int PS, long long inner, cudaStream_t stream) {
  const long long total = (long long)n * inner;
  const long long blocks = (total + kThreads - 1) / kThreads;
  paged_write_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<T*>(pages), static_cast<const T*>(rows), phys, off, valid,
      n, NP, PS, inner);
  return cudaGetLastError();
}

}  // namespace

// n planes (1..4): dst[i] [B, L, ...] and src[i] [B, 1, ...] contiguous,
// row_bytes[i] bytes a position, unit[i] bytes a thread copies (a divisor
// of row_bytes[i] to which both pointers are aligned); pos [B] int32.
// Returns the cudaError_t of the launch.
extern "C" int kv_slot_write_launch(int n, void* const* dst,
                                    const void* const* src,
                                    const long long* row_bytes,
                                    const int* unit, const void* pos, int B,
                                    int L, void* stream) {
  if (n < 1 || n > kMaxPlanes || B < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  SlotPlanes planes = {};
  long long most = 0;
  for (int i = 0; i < n; ++i) {
    const int u = unit[i];
    if ((u != 1 && u != 2 && u != 4 && u != 8 && u != 16) ||
        row_bytes[i] < 1 || row_bytes[i] % u != 0)
      return (int)cudaErrorInvalidValue;
    planes.p[i] = {static_cast<char*>(dst[i]),
                   static_cast<const char*>(src[i]), row_bytes[i], u};
    const long long units = (long long)B * (row_bytes[i] / u);
    most = units > most ? units : most;
  }
  const dim3 grid((unsigned)((most + kThreads - 1) / kThreads), n);
  slot_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, static_cast<const int*>(pos), B, L);
  return (int)cudaGetLastError();
}

// halves (1 or 2) of src[i] (f32 when src_code is 0, bf16 when 1) with
// element strides strides[3 i .. 3 i + 2] (row, step, head) into pages[i]
// (f32, bf16, int8 for dst_code 0, 1, 2) and, for int8, scales[i]; bt
// [B, PM] int64 with row stride bt_stride; pos
// [B] int32 or null (then every row starts at pos0); live [B] bool or
// null; wlen -1 for no gate; vec elements a lane-chunk (hd % vec == 0,
// every row of both sides aligned to vec elements); group lanes per
// (half, row, step, head). Returns the cudaError_t of the launch.
extern "C" int kv_paged_write_launch(
    int halves, const void* const* src, const long long* strides,
    void* const* pages, void* const* scales, int src_code, int dst_code,
    const void* bt, long long bt_stride, const void* pos,
    long long pos0, const void* live, long long wlen, int B, int S, int nkv,
    int hd, int NP, int PS, int PM, int vec, int group, void* stream) {
  if (halves < 1 || halves > 2 || B < 1 || S < 1 || nkv < 1 || hd < 1 ||
      NP < 1 || PS < 1 || PM < 1 || vec < 1 || hd % vec != 0 || group < 1 ||
      group > 32 || (group & (group - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  PagedArgs a = {};
  for (int i = 0; i < halves; ++i) {
    a.half[i] = {src[i], strides[3 * i], strides[3 * i + 1],
                 strides[3 * i + 2], pages[i],
                 static_cast<float*>(scales[i])};
    if (dst_code == 2 && scales[i] == nullptr)
      return (int)cudaErrorInvalidValue;
  }
  a.bt = static_cast<const long long*>(bt);
  a.bt_stride = bt_stride;
  a.pos = static_cast<const int*>(pos);
  a.pos0 = pos0;
  a.live = static_cast<const bool*>(live);
  a.wlen = wlen;
  a.halves = halves;
  a.B = B;
  a.S = S;
  a.nkv = nkv;
  a.hd = hd;
  a.NP = NP;
  a.PS = PS;
  a.PM = PM;
  a.group = group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (src_code) {
    case 0: return (int)launch_kv_paged_dst<float>(a, dst_code, vec, st);
    case 1:
      return (int)launch_kv_paged_dst<__nv_bfloat16>(a, dst_code, vec, st);
  }
  return (int)cudaErrorInvalidValue;
}

// pages [NP, PS, inner...] and rows [n, inner...] contiguous, same element
// size (1: int8, 2: bf16, 4: f32); phys, off, valid [n] int32. Returns the
// cudaError_t of the launch.
extern "C" int paged_write_launch(void* pages, const void* rows,
                                  const void* phys, const void* off,
                                  const void* valid, int n, int NP, int PS,
                                  long long inner, int elem_bytes,
                                  void* stream) {
  if (n < 1 || NP < 1 || PS < 1 || inner < 1)
    return (int)cudaErrorInvalidValue;
  const int* ph = static_cast<const int*>(phys);
  const int* of = static_cast<const int*>(off);
  const int* va = static_cast<const int*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return (int)launch_paged<int8_t>(pages, rows, ph, of, va, n, NP, PS,
                                       inner, st);
    case 2:
      return (int)launch_paged<uint16_t>(pages, rows, ph, of, va, n, NP, PS,
                                         inner, st);
    case 4:
      return (int)launch_paged<uint32_t>(pages, rows, ph, of, va, n, NP, PS,
                                         inner, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
