// Factor mix for Hopper (sm_90a): out[b, m] = sum_k w[b, k] * p[k, b, m],
// and its lane form out[g, b, m] = sum_k w[g, b, k] * p[g, k, b, m].
//
// Replaces the TPU kernel redcliff_tpu/ops/factor_mix.py::_factor_mix_kernel
// (a Pallas batched mat-vec over batch blocks of block_b rows, contracting
// the K factors on the MXU). Two callers use it:
//   * the REDCLIFF-S forward mixes the K per-factor one-step predictions,
//     w (B, K) x p (K, B, T*C);
//   * the serve engine blends the K static per-factor GC graphs per lane,
//     w (S, K) x p (K, C*C) broadcast over S, passed as stride_b = 0 so the
//     (K, S, C, C) broadcast is never materialised;
//   * the coefficient grid runs the training forward for G lanes at once
//     (the JAX package vmaps the Pallas kernel, whose batching rule adds a
//     grid axis): the second grid dimension is the lane, and w and p step by
//     their lane strides (stride_wg, stride_pg), out by B*M.
//
// What bounds it: memory. It reads 4*(B*K + K*B'*M) bytes (B' = 1 when the
// p operand is broadcast, else B) and writes 4*B*M, for 2*B*K*M flops: well
// under one flop per byte, far below the card's ridge point. At the main
// path's shapes (S=64, K=5, M=100 per serve tick; B=128, K=5, M=10 per
// training forward) the working set is 3-29 KB, so a launch is bound by
// launch latency, not by either roofline; the host-side launch path is the
// larger cost, and the wrapper keeps it short.
//
// Design: one thread per V = 1, 2 or 4 consecutive outputs of the linear
// (b, m) index, so every lane holds work whatever M is (M = 10 fills a warp
// as well as M = 100). V is chosen by the wrapper's launch plan
// (ops/factor_mix.py:mix_plan): 4 when M % 4 == 0 and p's base and strides
// are 16-byte aligned (the serve tick: 25 float4 per row), 2 at 8 bytes
// (the training shape, M = 10), else 1. M % V == 0 keeps a thread's V
// outputs inside one row b, so they share one w row and one p offset. The
// loads of p and w go through the read-only path (__ldg); the K loop is
// unrolled for K <= 16 and accumulates each output in an f32 register with
// fmaf, k = 0 .. K-1 in order. No shared memory, tensor cores or TMA: K is
// 2-9 and each p element is read once.
//
// Plain C interface (no PyTorch headers), bound with ctypes. The launch
// goes on the caller's stream, on the caller's device (set and restored
// only when it is not the current one), and returns cudaGetLastError(),
// which the Python wrapper checks.

#include <cuda_runtime.h>

namespace {

constexpr int kUnrollK = 16;

template <int V>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void fma(float (&acc)[1], float wk, const float* src) {
    acc[0] = fmaf(wk, __ldg(src), acc[0]);
  }
  __device__ static void store(float* dst, const float (&acc)[1]) {
    dst[0] = acc[0];
  }
};
template <>
struct Vec<2> {
  __device__ static void fma(float (&acc)[2], float wk, const float* src) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(src));
    acc[0] = fmaf(wk, v.x, acc[0]);
    acc[1] = fmaf(wk, v.y, acc[1]);
  }
  __device__ static void store(float* dst, const float (&acc)[2]) {
    *reinterpret_cast<float2*>(dst) = make_float2(acc[0], acc[1]);
  }
};
template <>
struct Vec<4> {
  __device__ static void fma(float (&acc)[4], float wk, const float* src) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    acc[0] = fmaf(wk, v.x, acc[0]);
    acc[1] = fmaf(wk, v.y, acc[1]);
    acc[2] = fmaf(wk, v.z, acc[2]);
    acc[3] = fmaf(wk, v.w, acc[3]);
  }
  __device__ static void store(float* dst, const float (&acc)[4]) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

// Per lane, n_vec = B * (M / V) < 2**31 threads do work (the wrapper
// checks B * M < 2**31, so 32-bit unsigned indices hold it); thread idx of
// lane blockIdx.y owns outputs [idx * V, idx * V + V) of that lane's
// row-major (B, M) output. A launch without lanes has gridDim.y = 1.
template <int V, bool kSmallK>
__global__ void __launch_bounds__(256)
    factor_mix_kernel(const float* __restrict__ w, const float* __restrict__ p,
                      float* __restrict__ out, int K, unsigned m_vec,
                      unsigned n_vec, long long stride_k, long long stride_b,
                      long long stride_wg, long long stride_pg) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vec) return;
  const long long g = blockIdx.y;
  const unsigned b = idx / m_vec;
  const unsigned m = (idx - b * m_vec) * V;
  const float* wb = w + g * stride_wg + (long long)b * K;
  const float* pb = p + g * stride_pg + (long long)b * stride_b + m;
  out += g * (long long)n_vec * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (kSmallK) {
#pragma unroll
    for (int k = 0; k < kUnrollK; ++k) {
      if (k < K) Vec<V>::fma(acc, __ldg(wb + k), pb + k * stride_k);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      Vec<V>::fma(acc, __ldg(wb + k), pb + k * stride_k);
    }
  }
  Vec<V>::store(out + (long long)idx * V, acc);
}

template <int V>
void launch(const float* w, const float* p, float* out, int K, int M,
            unsigned n_vec, long long stride_k, long long stride_b,
            long long stride_wg, long long stride_pg, int threads,
            dim3 blocks, cudaStream_t stream) {
  if (K <= kUnrollK) {
    factor_mix_kernel<V, true><<<blocks, threads, 0, stream>>>(
        w, p, out, K, M / V, n_vec, stride_k, stride_b, stride_wg,
        stride_pg);
  } else {
    factor_mix_kernel<V, false><<<blocks, threads, 0, stream>>>(
        w, p, out, K, M / V, n_vec, stride_k, stride_b, stride_wg,
        stride_pg);
  }
}

}  // namespace

// The launch's shapes, strides and plan, made once per shape by the wrapper
// (ops/factor_mix.py:_MixArgs, field for field), so a call converts five
// arguments instead of sixteen. G = 1 with zero lane strides is the launch
// without lanes.
struct MixArgs {
  int B, K, M;
  int vec, threads, blocks;  // the launch plan (ops/factor_mix.py:mix_plan)
  int device;
  long long stride_k, stride_b;
  int G;
  long long stride_wg, stride_pg;
};

// Lane g (0 <= g < G): w (B, K) contiguous at w + g*stride_wg; element
// (k, b, m) of p at p[g*stride_pg + k*stride_k + b*stride_b + m]; out
// (G, B, M) contiguous. The plan has checked that M % vec == 0 and that p,
// its strides and out are aligned to 4 * vec bytes. Returns a cudaError_t
// as int (0 = launched).
extern "C" int redcliff_factor_mix_f32(const float* w, const float* p,
                                       float* out, const MixArgs* args,
                                       void* stream) {
  const int B = args->B, K = args->K, M = args->M, vec = args->vec;
  const int threads = args->threads, blocks = args->blocks;
  const int device = args->device, G = args->G;
  const long long stride_k = args->stride_k, stride_b = args->stride_b;
  const long long stride_wg = args->stride_wg, stride_pg = args->stride_pg;
  if (B <= 0 || M <= 0 || G <= 0) return 0;
  if ((vec != 1 && vec != 2 && vec != 4) || M % vec != 0 || threads <= 0 ||
      threads > 256 || blocks <= 0 || G > 65535 ||
      (long long)B * M > 2147483647LL) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return (int)err;
  }
  const unsigned n_vec = (unsigned)B * (unsigned)(M / vec);
  const dim3 grid((unsigned)blocks, (unsigned)G);
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    launch<4>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
              stride_pg, threads, grid, s);
  } else if (vec == 2) {
    launch<2>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
              stride_pg, threads, grid, s);
  } else {
    launch<1>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
              stride_pg, threads, grid, s);
  }
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}
