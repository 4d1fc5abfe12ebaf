// Instruments for scripts/sanitize_kernels.py, not kernels of the port:
// smem_fill writes one 32-bit word over the shared memory of every SM,
// and smem_peek counts, in blocks that write nothing first, the words of
// their shared memory that do not hold that word.  A kernel launched after
// smem_fill finds the word wherever it reads shared memory it never wrote,
// so two runs after two different words give the same bits only if the
// kernel reads no unwritten shared memory.  smem_peek shows that the word
// does reach the next kernel on this card: CUDA does not promise it.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void smem_fill_kernel(uint32_t word, int words) {
  extern __shared__ uint32_t s[];
  volatile uint32_t* vs = s;
  for (int i = threadIdx.x; i < words; i += blockDim.x) vs[i] = word;
}

__global__ void smem_peek_kernel(uint32_t word, int words,
                                 unsigned long long* other) {
  extern __shared__ uint32_t s[];
  volatile uint32_t* vs = s;
  unsigned n = 0;
  for (int i = threadIdx.x; i < words; i += blockDim.x) n += vs[i] != word;
  if (n) atomicAdd(other, (unsigned long long)n);
}

static int configure(const void* kern, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return (int)e;
}

// `blocks` blocks of 1024 threads, `bytes` of shared memory each (at most
// 232,448: one block an SM) fill it with `word`.
extern "C" int smem_fill(int word, int blocks, int bytes, void* stream) {
  int e = configure((const void*)smem_fill_kernel, bytes);
  if (e) return e;
  smem_fill_kernel<<<blocks, 1024, bytes, (cudaStream_t)stream>>>(
      (uint32_t)word, bytes / 4);
  return (int)cudaGetLastError();
}

// `blocks` blocks of `bytes` add to *other the words they find that are
// not `word`.
extern "C" int smem_peek(void* other, int word, int blocks, int bytes,
                         void* stream) {
  int e = configure((const void*)smem_peek_kernel, bytes);
  if (e) return e;
  smem_peek_kernel<<<blocks, 1024, bytes, (cudaStream_t)stream>>>(
      (uint32_t)word, bytes / 4, (unsigned long long*)other);
  return (int)cudaGetLastError();
}
