// Fused LED (low-rank) matmul for Hopper: y = (x @ A) @ B.
//
// Replaces src/repro/kernels/led_matmul.py::_led_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.led_matmul).  Same arithmetic, not the same
// blocks: t = x @ A is accumulated in fp32, t @ B is taken with B upcast to
// fp32 and fp32 accumulation, and y is rounded once to the input dtype
// (float32 or bfloat16).  Any M, K, R, N: ragged edges are masked here, so
// the caller pads nothing.
//
// What bounds it.  On the serving path M is the decode batch or a prefill
// chunk's bucket width (8..32 rows) while A and B are the layer's factors
// (up to 2048 x 1024 and 1024 x 11008), so at decode the work is bound by
// bytes: the least it can do is read A and B once each (2 * M * R * (K + N)
// operations against (K + N) * R weight elements: a few operations per
// byte, far below the card's ~295 bf16 operations per byte).  What the
// design does about it: the rank-R intermediate t never goes to device
// memory (the TPU kernel keeps it in VMEM), so device-memory traffic is x,
// A and B read once and y written once; the re-reads of A below come from
// L2.  It does not reach that bound yet: the recomputation described below
// makes it bound by FP32 FMA issue and load latency (see PERF.md).
//
// The TPU grid is sequential and keeps t in scratch across its N steps.  On
// this card blocks run in parallel with nothing carried between them, and
// a (rows, R) fp32 t at R = 1024 does not fit shared memory at useful row
// counts.  So one block owns an (M tile, N tile) of y and walks R in chunks
// of NT: for each chunk it computes t_c = x[Mtile, :] @ A[:, chunk] through a
// shared-memory x tile, keeps t_c in shared memory in fp32, and folds
// t_c @ B[chunk, Ntile] into fp32 registers.  y is written once.  The price
// is that every N tile recomputes x @ A: A is read once per N tile (from L2
// after the first), and the block's FMA work is K * R * BM regardless of N.
// Tensor cores (wgmma), TMA and removing the recomputation are later work.
//
// One thread per column: in the first phase thread i owns column r0 + i of
// the rank chunk, in the second column n0 + i of the N tile, and each
// accumulates BM rows.  Neighbouring threads read neighbouring elements of A
// and B (coalesced); x and t_c are read from shared memory as broadcasts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int NT = 256;  // threads per block = rank-chunk width = N-tile width
constexpr int BK = 64;   // K extent of the x tile staged in shared memory

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int BM>
__global__ void __launch_bounds__(NT)
led_matmul_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ b, T* __restrict__ y,
                  int M, int K, int R, int N) {
  __shared__ __align__(16) float xs[BK][BM];  // x tile, transposed: xs[k][m]
  __shared__ __align__(16) float ts[NT][BM];  // rank chunk of t: ts[r][m]

  const int tid = threadIdx.x;
  const int n = blockIdx.x * NT + tid;
  const int m0 = blockIdx.y * BM;

  float yacc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) yacc[m] = 0.f;

  for (int r0 = 0; r0 < R; r0 += NT) {
    const int r = r0 + tid;
    float tacc[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) tacc[m] = 0.f;

    // phase 1: t_c[:, tid] = x[Mtile, :] @ A[:, r]
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // every thread is done reading the previous x tile
      for (int i = tid; i < BM * BK; i += NT) {
        const int mm = i / BK, kk = i % BK;  // consecutive threads: consecutive k
        const int gm = m0 + mm, gk = k0 + kk;
        xs[kk][mm] = (gm < M && gk < K) ? to_f32(x[(size_t)gm * K + gk]) : 0.f;
      }
      __syncthreads();
      if (r < R) {
        const int kn = min(BK, K - k0);
        const T* ap = a + (size_t)k0 * R + r;
#pragma unroll 8
        for (int kk = 0; kk < kn; ++kk) {
          const float av = to_f32(ap[(size_t)kk * R]);
#pragma unroll
          for (int m = 0; m < BM; ++m) tacc[m] = fmaf(xs[kk][m], av, tacc[m]);
        }
      }
    }

    __syncthreads();  // every thread is done reading the previous t_c
#pragma unroll
    for (int m = 0; m < BM; ++m) ts[tid][m] = (r < R) ? tacc[m] : 0.f;
    __syncthreads();

    // phase 2: y[Mtile, n] += t_c @ B[chunk, n]
    if (n < N) {
      const int rn = min(NT, R - r0);
      const T* bp = b + (size_t)r0 * N + n;
#pragma unroll 8
      for (int rr = 0; rr < rn; ++rr) {
        const float bv = to_f32(bp[(size_t)rr * N]);
#pragma unroll
        for (int m = 0; m < BM; ++m) yacc[m] = fmaf(ts[rr][m], bv, yacc[m]);
      }
    }
  }

  if (n < N) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m0 + m < M) y[(size_t)(m0 + m) * N + n] = from_f32<T>(yacc[m]);
    }
  }
}

template <typename T, int BM>
void launch(const void* x, const void* a, const void* b, void* y, int M, int K,
            int R, int N, cudaStream_t stream) {
  const dim3 grid((N + NT - 1) / NT, (M + BM - 1) / BM);
  led_matmul_kernel<T, BM><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<T*>(y), M, K, R, N);
}

template <typename T>
void launch_rows(const void* x, const void* a, const void* b, void* y, int M,
                 int K, int R, int N, cudaStream_t stream) {
  // the row tile follows M: the decode batch and the prefill buckets
  if (M <= 8) {
    launch<T, 8>(x, a, b, y, M, K, R, N, stream);
  } else if (M <= 16) {
    launch<T, 16>(x, a, b, y, M, K, R, N, stream);
  } else {
    launch<T, 32>(x, a, b, y, M, K, R, N, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x (M, K), a (K, R), b (R, N) and
// y (M, N) are contiguous row-major on the current device; the launch goes on
// `stream`.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int led_matmul_launch(const void* x, const void* a, const void* b,
                                 void* y, int M, int K, int R, int N,
                                 int dtype, void* stream) {
  if (M < 1 || K < 1 || R < 1 || N < 1 || (M + 31) / 32 > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_rows<float>(x, a, b, y, M, K, R, N, s);
  } else if (dtype == 1) {
    launch_rows<__nv_bfloat16>(x, a, b, y, M, K, R, N, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* led_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
