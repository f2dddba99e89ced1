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
// trainer's GISTA step after every factor optimizer step
// (models/redcliff.py apply_prox).
//
// What bounds it: memory. It reads W1 once and writes it once, 8 bytes per
// element, and does ~4 flops per element. At the training shape
// (K, C_out, H, C_in, L) = (5, 10, 25, 10, 4) that is 500 groups of 100
// floats, 400 KB in all: 0.12 us at 3.35 TB/s, so a launch is bound by
// launch latency, not by either roofline.
//
// Design: one warp per group. The warp reads its group straight from the
// strided layout (element (h, l) of group (lead, i) sits at
// lead*H*C_in*L + (h*C_in + i)*L + l), so the moveaxis copy of the TPU
// wrapper is never made. Lanes stride over the H*L elements and
// accumulate squares in f32 (fmaf); a __shfl_xor_sync butterfly gives
// every lane the group's sum of squares; each lane then rescales the
// elements it read. Each element is read and written by the same lane, so
// `out` may alias `w` (an in-place update is safe). Division and sqrt are
// the IEEE-exact ones (no fast math), so the result differs from the plain
// version only by the order of the sum of squares. NaN propagates through
// the max as it does in jnp.maximum / torch.clamp_min.
//
// Plain C interface (no PyTorch headers), bound with ctypes. The launch
// goes on the caller's stream and returns cudaGetLastError(), which the
// Python wrapper checks.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}

__global__ void gl_prox_kernel(const float* w, float* out,
                               long long G, int H, int C, int L, float t) {
  const long long group =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (group >= G) return;  // uniform across the warp

  const long long lead = group / C;
  const int i = (int)(group - lead * C);
  const long long base = lead * (long long)H * C * L + (long long)i * L;
  const long long h_stride = (long long)C * L;
  const int n_elem = H * L;

  float acc = 0.0f;
  for (int e = lane; e < n_elem; e += 32) {
    const int h = e / L;
    const float v = w[base + h * h_stride + (e - h * L)];
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  const float norm = sqrtf(acc);
  const float denom = nan_max(norm, t);
  const float scale = nan_max(norm - t, 0.0f);

  for (int e = lane; e < n_elem; e += 32) {
    const int h = e / L;
    const long long idx = base + h * h_stride + (e - h * L);
    out[idx] = w[idx] / denom * scale;
  }
}

}  // namespace

// w, out: (lead..., H, C, L) contiguous float32, out may equal w;
// G = prod(lead) * C groups. Returns a cudaError_t as int (0 = launched).
extern "C" int redcliff_gl_prox_f32(const float* w, float* out, long long G,
                                    int H, int C, int L, float t,
                                    void* stream) {
  if (G <= 0 || H <= 0 || L <= 0) return 0;
  const long long blocks = (G + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  gl_prox_kernel<<<(unsigned int)blocks, 32 * kWarpsPerBlock, 0,
                   (cudaStream_t)stream>>>(w, out, G, H, C, L, t);
  return (int)cudaGetLastError();
}
