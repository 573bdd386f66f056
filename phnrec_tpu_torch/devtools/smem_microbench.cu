// Microbenchmarks of what feeds an FP32 kernel on one SM: shared-memory
// loads of 16 and 4 bytes a lane under several address patterns, and a pure
// FMA stream.  Each kernel runs one block an SM and reports its clocks.
// Driven by smem_microbench.py.

#include <cuda_runtime.h>
#include <stdint.h>

// MODE 0: all lanes one address; 1: 4 addresses (lane >> 3); 2: 8 addresses
// (lane & 7); 3: 32 addresses (neighbouring float4)
template <int MODE>
__global__ void lds128(float* out, int iters, long long* cyc) {
  __shared__ float4 buf[2048];
  for (int i = threadIdx.x; i < 2048; i += blockDim.x)
    buf[i] = make_float4(i, 1, 2, 3);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int a = MODE == 0 ? 0 : MODE == 1 ? (lane >> 3) : MODE == 2 ? (lane & 7)
                                                             : lane;
  a += (threadIdx.x >> 5) * 32;
  float4 s[8];
  for (int j = 0; j < 8; ++j) s[j] = make_float4(0, 0, 0, 0);
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 v = buf[(a + j * 64 + i) & 2047];
      s[j].x += v.x;
      s[j].y += v.y;
      s[j].z += v.z;
      s[j].w += v.w;
    }
  }
  const long long t1 = clock64();
  float r = 0;
  for (int j = 0; j < 8; ++j) r += s[j].x + s[j].y + s[j].z + s[j].w;
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

// MODE 0: all lanes one address; 1: 32 neighbouring addresses
template <int MODE>
__global__ void lds32(float* out, int iters, long long* cyc) {
  __shared__ float buf[4096];
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) buf[i] = i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int a = (MODE == 0 ? 0 : lane) + (threadIdx.x >> 5) * 32;
  float s[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] += buf[(a + j * 64 + i) & 4095];
  }
  const long long t1 = clock64();
  float r = 0;
  for (int j = 0; j < 8; ++j) r += s[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

__global__ void fma_only(float* out, int iters, long long* cyc) {
  float a[32];
  for (int j = 0; j < 32; ++j) a[j] = threadIdx.x + j;
  const float x = out[0], y = out[1];
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 32; ++j) a[j] = fmaf(a[j], x, y);
  }
  const long long t1 = clock64();
  float r = 0;
  for (int j = 0; j < 32; ++j) r += a[j];
  out[2 + blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

// which: 0-3 lds128 modes, 4-5 lds32 modes, 6 fma_only.  out holds
// 2 + blocks * threads floats, cyc one int64 a block.
extern "C" int phn_smem_microbench(int which, int blocks, int threads,
                                   int iters, float* out, long long* cyc) {
  switch (which) {
    case 0: lds128<0><<<blocks, threads>>>(out, iters, cyc); break;
    case 1: lds128<1><<<blocks, threads>>>(out, iters, cyc); break;
    case 2: lds128<2><<<blocks, threads>>>(out, iters, cyc); break;
    case 3: lds128<3><<<blocks, threads>>>(out, iters, cyc); break;
    case 4: lds32<0><<<blocks, threads>>>(out, iters, cyc); break;
    case 5: lds32<1><<<blocks, threads>>>(out, iters, cyc); break;
    case 6: fma_only<<<blocks, threads>>>(out, iters, cyc); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
