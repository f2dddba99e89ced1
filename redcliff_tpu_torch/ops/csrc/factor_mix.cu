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
// The bf16 form (redcliff_factor_mix_bf16) is the same kernel on bf16 inputs:
// the serve engine's mixed-precision blend, w (S, K) and the K static
// graphs (K, C*C) both bf16, broadcast over S with stride_b = 0 (the JAX
// package's mixed dispatch contracts bf16 operands on the MXU,
// redcliff_tpu/serve/engine.py). Each operand is widened to f32 exactly
// (the bf16 bits are the top half of the f32's), accumulated in f32 with
// fmaf in K order, and the output is f32 (S, C*C). V bf16 values are one
// 2V-byte load: a row of 100 bf16 is 200 bytes, 8- but not 16-byte aligned,
// so the serve tick takes V = 4 (8-byte loads) and the wrapper's plan
// (mix_plan with itemsize 2) checks alignment at 2V bytes. It moves half
// the input bytes of the f32 form; at S = 64 the launch, not the bytes,
// still bounds it.
//
// Plain C interface (no PyTorch headers), bound with ctypes. The launch
// goes on the caller's stream, on the caller's device (set and restored
// only when it is not the current one), and returns cudaGetLastError(),
// which the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kUnrollK = 16;

// bf16 -> f32 is exact: the bf16 bits become the top half of the f32's
__device__ __forceinline__ float widen_lo(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float widen_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}
__device__ __forceinline__ float load1(const float* src) { return __ldg(src); }
__device__ __forceinline__ float load1(const __nv_bfloat16* src) {
  return widen_lo(__ldg(reinterpret_cast<const unsigned short*>(src)));
}

// acc[j] += wk * src[j] for V consecutive inputs of type float or bf16 (one
// vector load), and the store of V f32 outputs
template <int V>
struct Vec;
template <>
struct Vec<1> {
  template <typename T>
  __device__ static void fma(float (&acc)[1], float wk, const T* src) {
    acc[0] = fmaf(wk, load1(src), acc[0]);
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
  __device__ static void fma(float (&acc)[2], float wk,
                             const __nv_bfloat16* src) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(src));
    acc[0] = fmaf(wk, widen_lo(u), acc[0]);
    acc[1] = fmaf(wk, widen_hi(u), acc[1]);
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
  __device__ static void fma(float (&acc)[4], float wk,
                             const __nv_bfloat16* src) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    acc[0] = fmaf(wk, widen_lo(u.x), acc[0]);
    acc[1] = fmaf(wk, widen_hi(u.x), acc[1]);
    acc[2] = fmaf(wk, widen_lo(u.y), acc[2]);
    acc[3] = fmaf(wk, widen_hi(u.y), acc[3]);
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
// T is the input type (float, or __nv_bfloat16 for the bf16 form); the
// output and the sums are f32 either way.
template <typename T, int V, bool kSmallK>
__global__ void __launch_bounds__(256)
    factor_mix_kernel(const T* __restrict__ w, const T* __restrict__ p,
                      float* __restrict__ out, int K, unsigned m_vec,
                      unsigned n_vec, long long stride_k, long long stride_b,
                      long long stride_wg, long long stride_pg) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vec) return;
  const long long g = blockIdx.y;
  const unsigned b = idx / m_vec;
  const unsigned m = (idx - b * m_vec) * V;
  const T* wb = w + g * stride_wg + (long long)b * K;
  const T* pb = p + g * stride_pg + (long long)b * stride_b + m;
  out += g * (long long)n_vec * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if (kSmallK) {
#pragma unroll
    for (int k = 0; k < kUnrollK; ++k) {
      if (k < K) Vec<V>::fma(acc, load1(wb + k), pb + k * stride_k);
    }
  } else {
    for (int k = 0; k < K; ++k) {
      Vec<V>::fma(acc, load1(wb + k), pb + k * stride_k);
    }
  }
  Vec<V>::store(out + (long long)idx * V, acc);
}

template <typename T, int V>
void launch(const T* w, const T* p, float* out, int K, int M,
            unsigned n_vec, long long stride_k, long long stride_b,
            long long stride_wg, long long stride_pg, int threads,
            dim3 blocks, cudaStream_t stream) {
  if (K <= kUnrollK) {
    factor_mix_kernel<T, V, true><<<blocks, threads, 0, stream>>>(
        w, p, out, K, M / V, n_vec, stride_k, stride_b, stride_wg,
        stride_pg);
  } else {
    factor_mix_kernel<T, V, false><<<blocks, threads, 0, stream>>>(
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

namespace {

// The launch shared by both entry points. Lane g (0 <= g < G): w (B, K)
// contiguous at w + g*stride_wg; element (k, b, m) of p at
// p[g*stride_pg + k*stride_k + b*stride_b + m]; out (G, B, M) f32
// contiguous. The plan has checked that M % vec == 0 and that p and its
// strides are aligned to sizeof(T) * vec bytes and out to 4 * vec. Returns
// a cudaError_t as int (0 = launched).
template <typename T>
int run(const T* w, const T* p, float* out, const MixArgs* args,
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
    launch<T, 4>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
                 stride_pg, threads, grid, s);
  } else if (vec == 2) {
    launch<T, 2>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
                 stride_pg, threads, grid, s);
  } else {
    launch<T, 1>(w, p, out, K, M, n_vec, stride_k, stride_b, stride_wg,
                 stride_pg, threads, grid, s);
  }
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

extern "C" int redcliff_factor_mix_f32(const float* w, const float* p,
                                       float* out, const MixArgs* args,
                                       void* stream) {
  return run<float>(w, p, out, args, stream);
}

// The bf16 form: bf16 w and p, f32 out and sums; the same plan with vec
// counting bf16 values.
extern "C" int redcliff_factor_mix_bf16(const __nv_bfloat16* w,
                                        const __nv_bfloat16* p, float* out,
                                        const MixArgs* args, void* stream) {
  return run<__nv_bfloat16>(w, p, out, args, stream);
}
