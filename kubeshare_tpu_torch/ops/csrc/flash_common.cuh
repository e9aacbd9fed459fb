// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the float32 kernels' tiles and key ranges, the mask of a (query, key)
// pair, and small helpers.
//
// Who uses what. The bf16 kernels (flash_fwd_bf16, flash_bwd_dq_bf16,
// flash_bwd_dkv_bf16) have their own tiles (in their .cu files), Hopper
// helpers (hopper.cuh) and key or row ranges (their work lists, built on
// the host); of this file they take visible, NEG_INF, exp2_approx,
// pack_bf16 and allow_smem. BQ, BK, LDQ, LDK, FMA_THREADS and key_range
// are the float32 kernels' (forward and backward).
//
// Positions: causal rows align to the end of the keys (query i sits at
// position i + Tk - Tq; the wrappers require Tq <= Tk). A pair (query at
// qpos, key at kpos) is visible when kpos < Tk and, under a causal mask,
// kpos <= qpos and, with a window, kpos > qpos - window. Masked scores are
// -1e30, as in the reference kernels.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per q tile
constexpr int BK = 64;  // keys per tile (FLASH_BLOCK_K in attention.py)
constexpr float NEG_INF = -1e30f;

constexpr int FMA_THREADS = 256;  // float32 kernels: a 16 x 16 grid
constexpr int LDQ = BQ + 1;       // padded leading dims of the float32
constexpr int LDK = BK + 1;       // kernels' tiles: conflict-free stores

// Keys [lo, hi) that any real query of the q tile at q0 can see, and the
// absolute position of the tile's first query.
struct KeyRange {
  int lo, hi, q_first;
};

__device__ __forceinline__ KeyRange key_range(int q0, int t_q, int t_k,
                                              int causal, int window) {
  const int offset = causal ? t_k - t_q : 0;
  KeyRange r{0, t_k, q0 + offset};
  if (causal) {
    r.hi = min(t_k, min(q0 + BQ, t_q) - 1 + offset + 1);
    if (window > 0) r.lo = max(0, r.q_first - window + 1);
  }
  r.lo -= r.lo % BK;  // tiles are aligned to BK
  return r;
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int t_k,
                                        int causal, int window) {
  bool vis = kpos < t_k;
  if (causal) {
    vis = vis && kpos <= qpos;
    if (window > 0) vis = vis && kpos > qpos - window;
  }
  return vis;
}

// 2^x on the special-function unit (relative error at most 2^-22); the
// bf16 kernels fold log2(e) into the FFMA that forms x.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in low bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Opt a kernel into more than 48 KB of dynamic shared memory (per device,
// so on every launch: the call is cheap).
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
