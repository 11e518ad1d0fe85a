// K6: fused bias + exact GELU, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the custom-op example
// examples/custom_op_and_quant.py (bias_gelu -> _bias_gelu_kernel):
// y = gelu_erf(x + b) = z * 0.5 * (1 + erf(z * 0.70710678)), z = x + b,
// cast to x's dtype.  The TPU wrapper broadcast b to x's shape in device
// memory before the call; here b stays a [N] vector and each element reads
// its column's entry (i % N), so the extra x-sized read is gone.
//
// What bounds it on this card: one read of x, one write of y and one read
// of b for ~20 operations per element, far below the H100's ~295
// operations per byte: a good kernel is bound by device-memory bytes.
//
// Design, simple and right first: a grid-stride loop over 16-byte vectors
// of x (4 float32 or 8 half / bfloat16 elements) when x and y are 16-byte
// aligned, with the vector's first column taken modulo N once and stepped
// with a wrap per element; the last numel % VEC elements (or all of them,
// when the pointers do not allow vectors) go through a scalar loop.  The
// arithmetic is float32 with erff, rounded once to x's dtype; b may be of
// another floating type than x (a float32 bias under bf16 AMP).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gelu_erf(float z) {
  return z * 0.5f * (1.0f + erff(z * 0.70710678f));
}

template <typename T>
struct alignas(16) Vec {
  static constexpr int kN = 16 / sizeof(T);
  T e[kN];
};

// x, y: contiguous, n elements; b: [N].  Vectors 0 .. nvec-1 cover the
// first nvec * VEC elements; elements from `tail` on are scalar.
template <typename T, typename B>
__global__ void __launch_bounds__(kThreads)
bias_gelu_kernel(const T* __restrict__ x, const B* __restrict__ b,
                 T* __restrict__ y, long long n, int N, long long nvec) {
  constexpr int VEC = Vec<T>::kN;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Vec<T>* xv = reinterpret_cast<const Vec<T>*>(x);
  Vec<T>* yv = reinterpret_cast<Vec<T>*>(y);
  for (long long i = tid; i < nvec; i += stride) {
    Vec<T> a = xv[i];
    int c = static_cast<int>((i * VEC) % N);
    Vec<T> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float z = ptt::to_f32(a.e[j]) + ptt::to_f32(__ldg(b + c));
      o.e[j] = ptt::from_f32<T>(gelu_erf(z));
      if (++c == N) c = 0;
    }
    yv[i] = o;
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride) {
    float z = ptt::to_f32(x[i]) + ptt::to_f32(__ldg(b + i % N));
    y[i] = ptt::from_f32<T>(gelu_erf(z));
  }
}

template <typename T, typename B>
cudaError_t launch(const void* x, const void* b, void* y, long long n, int N,
                   cudaStream_t stream) {
  constexpr int VEC = Vec<T>::kN;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(y) % 16 == 0;
  // the per-element column wrap steps by one, so a vector may wrap once
  const long long nvec = (aligned && N >= VEC) ? n / VEC : 0;
  const long long work = nvec > 0 ? nvec : n;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // enough blocks to fill every SM (8 blocks of 256 threads each), never
  // more than the work needs
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  bias_gelu_kernel<T, B><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const B*>(b), static_cast<T*>(y),
      n, N, nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bias(int bias_dtype, const void* x, const void* b, void* y,
                        long long n, int N, cudaStream_t stream) {
  switch (bias_dtype) {
    case ptt::kF32: return launch<T, float>(x, b, y, n, N, stream);
    case ptt::kF16: return launch<T, __half>(x, b, y, n, N, stream);
    case ptt::kBF16: return launch<T, __nv_bfloat16>(x, b, y, n, N, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: contiguous, n elements whose last dim is N; b: contiguous [N]; y:
// contiguous, x's shape and dtype.  dtype / bias_dtype: codes of
// common.cuh.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ptt_bias_gelu(const void* x, const void* b, void* y,
                             long long n, int N, int dtype, int bias_dtype,
                             void* stream) {
  if (n == 0) return 0;
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  PTT_DISPATCH_DTYPE(dtype, {
    err = launch_bias<scalar_t>(bias_dtype, x, b, y, n, N, s);
  });
  return static_cast<int>(err);
}
