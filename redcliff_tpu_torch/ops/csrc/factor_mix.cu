// Factor mix for Hopper (sm_90a): out[b, m] = sum_k w[b, k] * p[k, b, m],
// and its lane form out[g, b, m] = sum_k w[g, b, k] * p[g, k, b, m].
//
// Replaces the TPU kernel redcliff_tpu/ops/factor_mix.py::_factor_mix_kernel
// (a Pallas batched mat-vec over batch blocks of block_b rows, contracting
// the K factors on the MXU). Three callers use it:
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
// Input forms. Each operand is read in one of three forms, fixed per entry
// point:
//   * f32, taken as it is (redcliff_factor_mix_f32, the f32 path);
//   * bf16, widened to f32 exactly: the bf16 bits are the top half of the
//     f32's (redcliff_factor_mix_bf16, bf16 operands);
//   * f32 rounded to bf16 in registers (__float2bfloat16_rn, then widened):
//     round to nearest even, subnormals kept, values past the bf16 maximum
//     to +-inf, +-inf kept, NaN kept NaN, i.e. the value
//     Tensor.to(torch.bfloat16) gives. redcliff_factor_mix_bf16_round takes
//     f32 w and p, both rounded: the mixed training forward and its lanes
//     (JAX's "bfloat16" matmul precision rounds both operands of the
//     contraction). redcliff_factor_mix_bf16_round_w takes f32 w, rounded,
//     and bf16 p: the mixed serve blend of f32 scores against the bf16
//     graphs the engine makes once at load.
// The bf16 entries are the bf16 form; whatever the input form, the sums are
// f32 with fmaf, k = 0 .. K-1 in order, and the output is f32. So a rounding
// entry gives bit for bit what casting each f32 operand to bf16 and
// launching redcliff_factor_mix_bf16 gives, with one launch instead of
// three (two casts and the mix) and without the two bf16 temporaries: per
// element of p it reads 4 bytes where the cast path moved 8 (the cast read
// 4 and wrote 2, the mix read 2).
//
// What bounds it: launch latency. It reads each input once and writes
// 4*B*M bytes, for 2*B*K*M flops: under one flop per byte, far below the
// card's ridge point, so memory would bound it if anything did. At the main
// path's shapes the bytes are: training (B=128 K=5 M=10, f32 w and p)
// 33,280 B; its lanes at G=32 1,064,960 B; the mixed serve blend (S=64 K=5
// M=100, f32 w, bf16 graphs broadcast over S) 27,880 B (the f32 serve tick
// 28,880 B). At 3.35 TB/s that is 8.3-9.9 ns of HBM time for the single
// shapes and 318 ns for the lanes, and the flops take 0.2-6.1 ns at the
// f32 rate, against a launch of about 2 us: every shape is bound by launch
// latency, not by either roofline. The host-side launch path is the larger
// cost, and the wrapper keeps it short.
//
// Design: one thread per V = 1, 2 or 4 consecutive outputs of the linear
// (b, m) index, so every lane holds work whatever M is (M = 10 fills a warp
// as well as M = 100). V is chosen by the wrapper's launch plan
// (ops/factor_mix.py:mix_plan) from p's storage: an f32 p takes float4 loads
// when M % 4 == 0 and p's base and strides are 16-byte aligned (the f32
// serve tick: 25 float4 per row), float2 at 8 bytes (the training shape,
// M = 10, rounded or not), else scalars; a bf16 p takes V bf16 values in one
// 2V-byte load (a row of 100 bf16 is 200 bytes, 8- but not 16-byte aligned,
// so the serve blend takes V = 4, 8-byte loads). M % V == 0 keeps a
// thread's V outputs inside one row b, so they share one w row and one p
// offset. The loads go through the read-only path (__ldg), and each output
// accumulates in an f32 register.
//
// The K loop is what sets a launch's device time at these shapes: a wave
// of a few blocks whose threads each wait for their loads, then run K
// dependent fmaf. K is a template argument for K <= 8 (the launch picks
// the instantiation; the port's paths launch K = 1, 2, 3, 4, 5, 6 and 9,
// the last through the blocked loop below), so the loop
// unrolls exactly and has no branch: all K loads of a thread are issued
// before the first product, one memory round trip in all. A loop unrolled
// to a fixed bound behind `if (k < K)` guards would put a branch before
// each k's loads wherever the compiler does not predicate them, so that
// each k waits for the one before (the rounding forms ran slower than the
// f32 kernel that way), and every thread would run the bound's iterations
// whatever K is. Past K = 8 the factors go in
// blocks of 8, each block's loads issued at once.
//
// Why no shared memory, TMA or wgmma: each element of w and p is read once
// and used in one product, so there is nothing to stage and reuse. Shared
// memory or a TMA copy would add a round trip through the SM and a barrier
// before the first product; wgmma wants a depth of 16 bf16 (K = 5 pads to
// 16, 3.2x the work) and 64-row tiles of a product that is a batched
// mat-vec (one w row per output row), and the tensor cores would only wait
// on the same loads. At these sizes a launch is about as short as a kernel
// on this card gets.
//
// Plain C interface (no PyTorch headers), bound with ctypes. The launch
// goes on the caller's stream, on the caller's device (set and restored
// only when it is not the current one), and returns cudaGetLastError(),
// which the Python wrapper checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// K up to kExactK is a template argument (one instantiation per K); past
// it the factors go in blocks of kBlockK
constexpr int kExactK = 8;
constexpr int kBlockK = 8;

// bf16 -> f32 is exact: the bf16 bits become the top half of the f32's
__device__ __forceinline__ float widen_lo(unsigned int u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float widen_hi(unsigned int u) {
  return __uint_as_float(u & 0xffff0000u);
}

// An f32 value as the sums take it: as it is, or (kRound) rounded to bf16,
// to nearest even, and widened back
template <bool kRound>
__device__ __forceinline__ float take(float x) {
  if (kRound) {
    return widen_lo(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
  }
  return x;
}

// One stored input value as the sums take it
template <bool kRound>
__device__ __forceinline__ float load1(const float* src) {
  return take<kRound>(__ldg(src));
}
template <bool kRound>
__device__ __forceinline__ float load1(const __nv_bfloat16* src) {
  return widen_lo(__ldg(reinterpret_cast<const unsigned short*>(src)));
}

// acc[j] += wk * src[j] for V consecutive inputs stored as f32 (rounded to
// bf16 when kRound) or bf16 (one vector load), and the store of V f32
// outputs
template <int V>
struct Vec;
template <>
struct Vec<1> {
  template <bool kRound, typename T>
  __device__ static void fma(float (&acc)[1], float wk, const T* src) {
    acc[0] = fmaf(wk, load1<kRound>(src), acc[0]);
  }
  __device__ static void store(float* dst, const float (&acc)[1]) {
    dst[0] = acc[0];
  }
};
template <>
struct Vec<2> {
  template <bool kRound>
  __device__ static void fma(float (&acc)[2], float wk, const float* src) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(src));
    acc[0] = fmaf(wk, take<kRound>(v.x), acc[0]);
    acc[1] = fmaf(wk, take<kRound>(v.y), acc[1]);
  }
  template <bool kRound>
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
  template <bool kRound>
  __device__ static void fma(float (&acc)[4], float wk, const float* src) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    acc[0] = fmaf(wk, take<kRound>(v.x), acc[0]);
    acc[1] = fmaf(wk, take<kRound>(v.y), acc[1]);
    acc[2] = fmaf(wk, take<kRound>(v.z), acc[2]);
    acc[3] = fmaf(wk, take<kRound>(v.w), acc[3]);
  }
  template <bool kRound>
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
// TW and TP are w's and p's storage types (float or __nv_bfloat16);
// kRound rounds f32 storage to bf16. The output and the sums are f32.
// kK = K when K <= kExactK: the K loop unrolls exactly, with no branch, so
// the loads of all K factors are in flight at once. kK = 0 is any K: the
// factors in blocks of kBlockK, each block's loads issued at once (in the
// last block k past K re-reads K - 1 and its product is dropped).
template <bool kRound, typename TW, typename TP, int V, int kK>
__global__ void __launch_bounds__(256)
    factor_mix_kernel(const TW* __restrict__ w, const TP* __restrict__ p,
                      float* __restrict__ out, int K, unsigned m_vec,
                      unsigned n_vec, long long stride_k, long long stride_b,
                      long long stride_wg, long long stride_pg) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_vec) return;
  const long long g = blockIdx.y;
  const unsigned b = idx / m_vec;
  const unsigned m = (idx - b * m_vec) * V;
  const TW* wb = w + g * stride_wg + (long long)b * K;
  const TP* pb = p + g * stride_pg + (long long)b * stride_b + m;
  out += g * (long long)n_vec * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.0f;
  if constexpr (kK > 0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      Vec<V>::template fma<kRound>(acc, load1<kRound>(wb + k),
                                   pb + k * stride_k);
    }
  } else {
    for (int k0 = 0; k0 < K; k0 += kBlockK) {
#pragma unroll
      for (int j = 0; j < kBlockK; ++j) {
        const int k = min(k0 + j, K - 1);
        float part[V];
#pragma unroll
        for (int v = 0; v < V; ++v) part[v] = acc[v];
        Vec<V>::template fma<kRound>(part, load1<kRound>(wb + k),
                                     pb + k * stride_k);
        if (k0 + j < K) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = part[v];
        }
      }
    }
  }
  Vec<V>::store(out + (long long)idx * V, acc);
}

template <bool kRound, typename TW, typename TP, int V, int kK>
void launch_k(const TW* w, const TP* p, float* out, int K, int M,
              unsigned n_vec, long long stride_k, long long stride_b,
              long long stride_wg, long long stride_pg, int threads,
              dim3 blocks, cudaStream_t stream) {
  factor_mix_kernel<kRound, TW, TP, V, kK><<<blocks, threads, 0, stream>>>(
      w, p, out, K, M / V, n_vec, stride_k, stride_b, stride_wg, stride_pg);
}

// The instantiation for K: exact for 1 .. kExactK, blocked past it (and
// for K = 0, whose sums are 0)
template <bool kRound, typename TW, typename TP, int V, int kK = 1>
void launch(const TW* w, const TP* p, float* out, int K, int M,
            unsigned n_vec, long long stride_k, long long stride_b,
            long long stride_wg, long long stride_pg, int threads,
            dim3 blocks, cudaStream_t stream) {
  if constexpr (kK > kExactK) {
    launch_k<kRound, TW, TP, V, 0>(w, p, out, K, M, n_vec, stride_k,
                                   stride_b, stride_wg, stride_pg, threads,
                                   blocks, stream);
  } else {
    if (K == kK) {
      launch_k<kRound, TW, TP, V, kK>(w, p, out, K, M, n_vec, stride_k,
                                      stride_b, stride_wg, stride_pg,
                                      threads, blocks, stream);
    } else {
      launch<kRound, TW, TP, V, kK + 1>(w, p, out, K, M, n_vec, stride_k,
                                        stride_b, stride_wg, stride_pg,
                                        threads, blocks, stream);
    }
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

// The launch shared by every entry point. Lane g (0 <= g < G): w (B, K)
// contiguous at w + g*stride_wg; element (k, b, m) of p at
// p[g*stride_pg + k*stride_k + b*stride_b + m]; out (G, B, M) f32
// contiguous. The plan has checked that M % vec == 0 and that p and its
// strides are aligned to sizeof(TP) * vec bytes and out to 4 * vec.
// Returns a cudaError_t as int (0 = launched).
template <bool kRound, typename TW, typename TP>
int run(const TW* w, const TP* p, float* out, const MixArgs* args,
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
    launch<kRound, TW, TP, 4>(w, p, out, K, M, n_vec, stride_k, stride_b,
                              stride_wg, stride_pg, threads, grid, s);
  } else if (vec == 2) {
    launch<kRound, TW, TP, 2>(w, p, out, K, M, n_vec, stride_k, stride_b,
                              stride_wg, stride_pg, threads, grid, s);
  } else {
    launch<kRound, TW, TP, 1>(w, p, out, K, M, n_vec, stride_k, stride_b,
                              stride_wg, stride_pg, threads, grid, s);
  }
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

extern "C" int redcliff_factor_mix_f32(const float* w, const float* p,
                                       float* out, const MixArgs* args,
                                       void* stream) {
  return run<false, float, float>(w, p, out, args, stream);
}

// The bf16 form on bf16 operands: bf16 w and p widened, f32 out and sums;
// the same plan with vec counting bf16 values.
extern "C" int redcliff_factor_mix_bf16(const __nv_bfloat16* w,
                                        const __nv_bfloat16* p, float* out,
                                        const MixArgs* args, void* stream) {
  return run<true, __nv_bfloat16, __nv_bfloat16>(w, p, out, args, stream);
}

// The bf16 form on f32 operands, both rounded to bf16 in registers: the
// mixed training forward and its lanes; the plan of an f32 p.
extern "C" int redcliff_factor_mix_bf16_round(const float* w, const float* p,
                                              float* out,
                                              const MixArgs* args,
                                              void* stream) {
  return run<true, float, float>(w, p, out, args, stream);
}

// The bf16 form on f32 w, rounded in registers, and bf16 p: the mixed serve
// blend against the bf16 graphs; the plan of a bf16 p.
extern "C" int redcliff_factor_mix_bf16_round_w(const float* w,
                                                const __nv_bfloat16* p,
                                                float* out,
                                                const MixArgs* args,
                                                void* stream) {
  return run<true, float, __nv_bfloat16>(w, p, out, args, stream);
}
