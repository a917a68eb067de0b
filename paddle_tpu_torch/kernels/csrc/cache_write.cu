// KV-cache writes for Hopper (sm_90a), slot and paged forms.
//
// Slot form, cache[b, pos[b]] = rows[b, 0]: replaces the TPU kernel
// paddle_tpu/kernels/cache_write.py:fused_slot_write (bodies
// _slot_kernel_row / _slot_kernel_whole). The cache is [B, L, ...] (int8
// data [B, L, nkv, hd], its f32 scale plane [B, L, nkv], or f32/bf16 data),
// rows [B, 1, ...] of the same type, pos [B] int32; a row whose position
// lies outside [0, L) writes nothing, as the TPU kernel's select writes
// nothing there.
//
// Paged form, pages[phys[i], off[i]] = rows[i] where valid[i]: replaces
// paddle_tpu/kernels/cache_write.py:fused_paged_write (bodies
// _paged_kernel_whole / _paged_kernel_page). The pool half is [NP, PS, ...]
// (bf16/f32/int8 pages or the f32 [NP, PS, nkv] scale plane of an int8
// pool), rows [n, ...] of the same type, phys/off/valid [n] int32. A row
// writes only where valid[i] != 0, 0 <= phys[i] < NP and 0 <= off[i] < PS:
// the TPU kernel's page programs match no other row. Valid rows target
// distinct (page, offset) pairs (the caller's copy-on-write invariant);
// where two collide, which one lands is unspecified here, while the TPU
// kernel's sequential loop keeps the last.
//
// What bounds both on this card: launch latency. The TPU kernels stream a
// whole block (a slot's [1, L, ...] row, or each pool page) through VMEM;
// these touch only the new rows — one thread per element of the rows, a
// plain copy of the element's bits (the caller has already cast or
// quantised the rows), so a launch moves a few kilobytes at decode and
// under a megabyte at admission, and costs what a launch costs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__global__ void slot_write_kernel(T* __restrict__ cache,
                                  const T* __restrict__ rows,
                                  const int* __restrict__ pos, int B, int L,
                                  long long inner) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)B * inner) return;
  const int b = (int)(idx / inner);
  const long long e = idx - (long long)b * inner;
  const int p = pos[b];
  if (p < 0 || p >= L) return;
  cache[((long long)b * L + p) * inner + e] = rows[idx];
}

template <typename T>
cudaError_t launch(void* cache, const void* rows, const int* pos, int B,
                   int L, long long inner, cudaStream_t stream) {
  const long long n = (long long)B * inner;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  slot_write_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(cache), static_cast<const T*>(rows), pos, B, L, inner);
  return cudaGetLastError();
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
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  paged_write_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<T*>(pages), static_cast<const T*>(rows), phys, off, valid,
      n, NP, PS, inner);
  return cudaGetLastError();
}

}  // namespace

// cache [B, L, inner...] and rows [B, 1, inner...] contiguous, same element
// size (1: int8, 2: bf16, 4: f32); pos [B] int32. Returns the cudaError_t
// of the launch.
extern "C" int slot_write_launch(void* cache, const void* rows,
                                 const void* pos, int B, int L,
                                 long long inner, int elem_bytes,
                                 void* stream) {
  if (B < 1 || L < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  const int* p = static_cast<const int*>(pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      return (int)launch<int8_t>(cache, rows, p, B, L, inner, st);
    case 2:
      return (int)launch<uint16_t>(cache, rows, p, B, L, inner, st);
    case 4:
      return (int)launch<uint32_t>(cache, rows, p, B, L, inner, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
