// Does nvcc keep a loop's exit test when `#pragma unroll U` unrolls a loop
// with a runtime trip count whose body holds a warp-collective operation?
// The frame loops of kernels C and F (csrc/phnloop_viterbi.cu,
// csrc/lrtrace.cu) are such loops.  Each probe kernel runs `n` iterations,
// a warp-collective (or none) and one store a lane each, into a buffer
// filled with -1; the host counts the rows written, which must be n.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/unroll_probe \
//       phnrec_tpu_torch/devtools/unroll_probe.cu && build/unroll_probe
//
// One JSON line per (operation, unroll factor) with the trip counts that
// ran another number of iterations; exits 1 if any did.

#include <cuda_runtime.h>

#include <cstdio>

enum Op { NONE, SHFL, BALLOT, REDUX };

template <int U, Op OP>
__global__ void probe(int n, int* out) {
  const int lane = threadIdx.x;
  int x = lane;
#pragma unroll(U)
  for (int i = 0; i < n; ++i) {
    if (OP == SHFL) x = __shfl_sync(0xffffffffu, x + i, (lane + 1) & 31);
    if (OP == BALLOT) x += (int)__ballot_sync(0xffffffffu, (x + i) & 1);
    if (OP == REDUX) x += __reduce_max_sync(0xffffffffu, x + i);
    if (OP == NONE) x = x * 3 + i;
    out[i * 32 + lane] = x & 0x3fffffff;
  }
}

constexpr int MAX_N = 12, ROWS = MAX_N + 8;

template <int U, Op OP>
int run(const char* op, int* dev, int* host) {
  int bad = 0;
  printf("{\"op\": \"%s\", \"unroll\": %d, \"wrong\": [", op, U);
  for (int n = 1; n <= MAX_N; ++n) {
    cudaMemset(dev, 0xff, ROWS * 32 * sizeof(int));
    probe<U, OP><<<1, 32>>>(n, dev);
    cudaError_t err = cudaDeviceSynchronize();
    if (err != cudaSuccess) {
      printf("]}\nCUDA error %s\n", cudaGetErrorString(err));
      return 2;
    }
    cudaMemcpy(host, dev, ROWS * 32 * sizeof(int), cudaMemcpyDeviceToHost);
    int rows = 0;
    for (int r = 0; r < ROWS; ++r)
      if (host[r * 32] != -1) rows = r + 1;
    if (rows != n) {
      printf("%s{\"n\": %d, \"iterations\": %d}", bad ? ", " : "", n, rows);
      ++bad;
    }
  }
  printf("]}\n");
  return bad ? 1 : 0;
}

template <int U>
int all_ops(int* dev, int* host) {
  int rc = 0;
  rc |= run<U, NONE>("none", dev, host);
  rc |= run<U, SHFL>("shfl", dev, host);
  rc |= run<U, BALLOT>("ballot", dev, host);
  rc |= run<U, REDUX>("redux", dev, host);
  return rc;
}

int main() {
  int* dev = nullptr;
  static int host[ROWS * 32];
  if (cudaMalloc(&dev, sizeof(host)) != cudaSuccess) {
    printf("no CUDA device\n");
    return 2;
  }
  int rc = 0;
  rc |= all_ops<2>(dev, host);
  rc |= all_ops<3>(dev, host);
  rc |= all_ops<4>(dev, host);
  rc |= all_ops<5>(dev, host);
  cudaFree(dev);
  return rc;
}
