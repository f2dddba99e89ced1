// Group-lasso proximal update for Hopper (sm_90a).
//
// For every group g = (lead..., i) of a first-layer block W1 laid out as
// (lead..., H, C_in, L):
//     n = ||W1[lead, :, i, :]||_2               (over the H*L elements)
//     W1[lead, :, i, :] <- W1 / max(n, t) * max(n - t, 0),   t = lr * lam
//
// Replaces the TPU kernel redcliff_tpu/ops/pallas_prox.py::_gl_prox_kernel
// (a Pallas row-block pass over the (G, H*L) matrix that the JAX wrapper
// first builds with a moveaxis copy of W1). Callers: the REDCLIFF-S
// trainer's GISTA step after every factor optimizer step, in place on the
// live block (models/redcliff.py apply_prox_), the functional apply_prox,
// and the coefficient grid's step for all G lanes at once
// (models/redcliff.py apply_prox_lanes_).
//
// Lanes: the grid's stacked block is (G, lead..., H, C_in, L), and slab s
// belongs to lane s / slabs_per_lane. Each lane has its own threshold
// (the float32 product of the lane's lr and lam, as the JAX grid computes
// it under vmap) and its own gate, both read from device arrays: a block
// whose lane is gated off returns before it reads or writes anything, so
// the lane's slabs are left exactly as they were (a zero threshold would
// not do: a zero group gives 0 / max(0, 0) = NaN). Nothing is read back to
// the host.
//
// What bounds it: memory. It reads W1 once and writes it once, 8 bytes per
// element, and does ~4 flops per element. At the training shape
// (K, C_out, H, C_in, L) = (5, 10, 25, 10, 4) that is 500 groups of 100
// floats, 400 KB in all: 0.12 us at 3.35 TB/s, so a launch is bound by
// launch latency, not by either roofline.
//
// Design: one block per leading slab (lead...) of S = H*C_in*L contiguous
// floats, which holds all C_in groups of that slab (4,000 bytes and 50
// blocks at the training shape).
//   1. The block stages the slab in shared memory in one coalesced pass:
//      a 1-D TMA bulk copy (cp.async.bulk, completed on an mbarrier) when
//      the slab's address and size are multiples of 16 bytes, else scalar
//      loads, four in flight per thread.
//   2. A warp per group sums the squares of its H*L elements from shared
//      memory (element (h, l) of group i at (h*C_in + i)*L + l; four lags
//      as one float4 when L % 4 == 0 on the aligned path) in f32 with
//      fmaf, then a __shfl_xor_sync butterfly. The block has one warp per
//      group up to 16 warps (320 threads at C_in = 10), so at the training
//      shape every group's sum runs at once.
//   3. The block writes the rescaled slab back with coalesced stores
//      (float4 on the aligned path), reading it from shared memory, so each
//      element is read from device memory once.
// The launch is latency-bound, so the block's critical path is kept short:
// the first copy is issued before the block's first barrier, in-slab
// indices are 32-bit, and the write pass steps (group, lag) along a float4
// instead of dividing per element.
// A slab larger than the chunk the wrapper sets aside (ops/pallas_prox.py:
// prox_plan) is walked in chunks: step 1 and 2 run once per chunk and add
// per-group partial sums in shared memory, and step 3 reads the slab from
// device memory again — two passes inside the same kernel.
//
// Numerics: division and sqrt are the IEEE-exact ones (no fast math), the
// order is w / max(n, t) * max(n - t, 0) as in the plain version, and NaN
// propagates through the max as it does in jnp.maximum / torch.clamp_min;
// the result differs from the plain version only by the order of the sum
// of squares. A block reads its whole slab before it writes any of it and
// touches no other slab, so `out` may alias `w` (the in-place update).
//
// Plain C interface (no PyTorch headers), bound with ctypes. The launch
// goes on the caller's stream, on the caller's device (set and restored
// only when it is not the current one), and returns cudaGetLastError(),
// which the Python wrapper checks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbarrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one thread: arm the barrier for `bytes` and start the bulk copy
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  // shared memory the block read before is rewritten by the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbarrier_wait(uint64_t* bar,
                                              uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// the group i and lag l of slab element e, and a step to element e + 1
struct GroupWalk {
  int i, l;
  __device__ GroupWalk(int e, int C, int L) {
    const int g = e / L;
    l = e - g * L;
    i = g % C;
  }
  __device__ void next(int C, int L) {
    if (++l == L) {
      l = 0;
      if (++i == C) i = 0;
    }
  }
};

// grid: one block per slab, blockDim.x a multiple of 32; dynamic shared
// memory: [chunk] staged floats, then [C] per-group sums (later the
// denominators) and [C] scales. S = H*C*L < 2**31 (the wrapper checks).
// bulk != 0 requires w and out 16-byte aligned and S and chunk multiples
// of 4. With lane_t != nullptr the threshold of slab s is
// lane_t[s / slabs_per_lane], and the slab is skipped when that lane's
// lane_gate byte is 0; with lane_t == nullptr every slab takes t.
__global__ void __launch_bounds__(kMaxThreads)
    gl_prox_kernel(const float* w, float* out, int H, int C, int L,
                   int chunk, int bulk, float t,
                   const float* __restrict__ lane_t,
                   const unsigned char* __restrict__ lane_gate,
                   unsigned slabs_per_lane) {
  if (lane_t != nullptr) {
    const unsigned g = blockIdx.x / slabs_per_lane;
    if (lane_gate[g] == 0) return;  // the whole block: no barrier yet
    t = lane_t[g];
  }
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  float* stage = smem;
  float* denom = smem + chunk;
  float* scale = denom + C;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int warp = tid >> 5;
  const int warps = threads >> 5;
  const int lane = tid & 31;
  const int row = C * L;
  const int S = row * H;
  const float* src = w + (long long)blockIdx.x * S;
  float* dst = out + (long long)blockIdx.x * S;
  const int n_chunks = (S + chunk - 1) / chunk;

  // the first chunk's copy is in flight while the block zeroes its sums
  if (bulk && tid == 0) {
    mbarrier_init(&bar);
    bulk_load(stage, src, (uint32_t)min(chunk, S) * 4u, &bar);
  }
  for (int i = tid; i < C; i += threads) denom[i] = 0.0f;
  __syncthreads();

  // 1 + 2: stage each chunk, add its per-group sums of squares
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * chunk;
    const int n = min(chunk, S - c0);
    if (bulk) {
      if (c > 0 && tid == 0) {
        bulk_load(stage, src + c0, (uint32_t)n * 4u, &bar);
      }
      mbarrier_wait(&bar, (uint32_t)(c & 1));
    } else {
      // four loads in flight per thread before their stores
      for (int e0 = tid; e0 < n; e0 += 4 * threads) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * threads;
          v[j] = e < n ? src[c0 + e] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + j * threads;
          if (e < n) stage[e] = v[j];
        }
      }
      __syncthreads();
    }
    // the (h, l) pairs of a group that fall in rows h_lo .. h_hi; on the
    // bulk path with L % 4 == 0 a lane takes 4 lags as one float4 (chunk
    // boundaries are multiples of 4, so a float4 is wholly in or out)
    const int h_lo = c0 / row;
    const int pairs = ((c0 + n - 1) / row - h_lo + 1) * L;
    const bool quads = bulk && (L & 3) == 0;
    for (int i = warp; i < C; i += warps) {
      float acc = 0.0f;
      if (quads) {
        const int lq = L >> 2;
        for (int e = lane; e < (pairs >> 2); e += 32) {
          const int dh = e / lq;
          const int pos =
              (h_lo + dh) * row + i * L + 4 * (e - dh * lq) - c0;
          if (pos >= 0 && pos < n) {
            const float4 v = *reinterpret_cast<const float4*>(stage + pos);
            acc = fmaf(v.x, v.x, acc);
            acc = fmaf(v.y, v.y, acc);
            acc = fmaf(v.z, v.z, acc);
            acc = fmaf(v.w, v.w, acc);
          }
        }
      } else {
        for (int e = lane; e < pairs; e += 32) {
          const int dh = e / L;
          const int pos = (h_lo + dh) * row + i * L + (e - dh * L) - c0;
          if (pos >= 0 && pos < n) {
            const float v = stage[pos];
            acc = fmaf(v, v, acc);
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) denom[i] += acc;
    }
    __syncthreads();
  }

  for (int i = tid; i < C; i += threads) {
    const float norm = sqrtf(denom[i]);
    denom[i] = nan_max(norm, t);
    scale[i] = nan_max(norm - t, 0.0f);
  }
  __syncthreads();

  // 3: write back, w / max(n, t) * max(n - t, 0) per element; the values
  // come from shared memory when the whole slab is staged, else from
  // device memory again
  const float* from = n_chunks == 1 ? stage : src;
  if (bulk) {
    const float4* from4 = reinterpret_cast<const float4*>(from);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int q = tid; q < S / 4; q += threads) {
      float4 v = from4[q];
      GroupWalk g(4 * q, C, L);
      v.x = v.x / denom[g.i] * scale[g.i];
      g.next(C, L);
      v.y = v.y / denom[g.i] * scale[g.i];
      g.next(C, L);
      v.z = v.z / denom[g.i] * scale[g.i];
      g.next(C, L);
      v.w = v.w / denom[g.i] * scale[g.i];
      dst4[q] = v;
    }
  } else {
    for (int e = tid; e < S; e += threads) {
      const int i = (e / L) % C;
      dst[e] = from[e] / denom[i] * scale[i];
    }
  }
}

}  // namespace

// The launch's shape and plan, made once per shape by the wrapper
// (ops/pallas_prox.py:_ProxArgs, field for field), so a call converts five
// or six arguments instead of twelve or fourteen. slabs_per_lane is read
// by the lane entry only.
struct ProxArgs {
  long long lead;
  int H, C, L;
  int chunk, bulk, threads;  // the launch plan (ops/pallas_prox.py:prox_plan)
  int device;
  long long slabs_per_lane;
};

namespace {

int launch_prox(const float* w, float* out, const ProxArgs* args, float t,
                const float* lane_t, const unsigned char* lane_gate,
                void* stream) {
  const long long lead = args->lead;
  const int H = args->H, C = args->C, L = args->L, chunk = args->chunk;
  const int bulk = args->bulk, threads = args->threads;
  const int device = args->device;
  if (lead <= 0 || H <= 0 || C <= 0 || L <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)chunk + 2 * (size_t)C);
  if (lead > 2147483647LL || (long long)H * C * L > 2147483647LL ||
      chunk <= 0 || smem > 48 * 1024 - 64 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (bulk && (chunk % 4 != 0 || ((long long)H * C * L) % 4 != 0 ||
                reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (lane_t != nullptr &&
      (args->slabs_per_lane <= 0 || lead % args->slabs_per_lane != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) {
    return (int)err;
  }
  gl_prox_kernel<<<(unsigned int)lead, threads, smem,
                   (cudaStream_t)stream>>>(
      w, out, H, C, L, chunk, bulk, t, lane_t, lane_gate,
      (unsigned)args->slabs_per_lane);
  err = cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

// w, out: (lead, H, C, L) contiguous float32, out may equal w. The plan:
// chunk floats staged at a time; bulk = the TMA and float4 path, which
// needs w and out 16-byte aligned and H*C*L and chunk multiples of 4;
// threads a multiple of 32, at most 512. Dynamic shared memory is
// 4 * (chunk + 2*C) bytes, at most 48 KB less 64 bytes for the static
// mbarrier. Returns a cudaError_t as int (0 = launched).
extern "C" int redcliff_gl_prox_f32(const float* w, float* out,
                                    const ProxArgs* args, float t,
                                    void* stream) {
  return launch_prox(w, out, args, t, nullptr, nullptr, stream);
}

// The lane entry: as above, with lead = G * slabs_per_lane slabs, the
// threshold of lane g at lane_t[g] and its gate at lane_gate[g] (0 = leave
// the lane's slabs untouched), both device arrays of G elements.
extern "C" int redcliff_gl_prox_lanes_f32(const float* w, float* out,
                                          const ProxArgs* args,
                                          const float* lane_t,
                                          const unsigned char* lane_gate,
                                          void* stream) {
  if (lane_t == nullptr || lane_gate == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_prox(w, out, args, 0.0f, lane_t, lane_gate, stream);
}
