// S=1 slot KV-cache write for Hopper (sm_90a): cache[b, pos[b]] = rows[b, 0].
//
// Replaces the TPU kernel paddle_tpu/kernels/cache_write.py:fused_slot_write
// (bodies _slot_kernel_row / _slot_kernel_whole). The cache is [B, L, ...]
// (int8 data [B, L, nkv, hd], its f32 scale plane [B, L, nkv], or f32/bf16
// data), rows [B, 1, ...] of the same type, pos [B] int32; a row whose
// position lies outside [0, L) writes nothing, as the TPU kernel's select
// writes nothing there.
//
// What bounds it on this card: launch latency. The TPU kernel streams each
// row's whole [1, L, ...] block through VMEM; this one touches only the new
// rows — one thread per element of the B x prod(shape[2:]) rows, a plain
// copy of the element's bits (the caller has already cast or quantised the
// rows), so a launch moves a few kilobytes and costs what a launch costs.
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
