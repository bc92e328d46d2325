// RWKV-6 WKV recurrence for Hopper (sm_90a).  Per (batch b, head h), with
// an hd x hd fp32 state S:
//   out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//   S_t   = diag(w_t) S_{t-1} + k_t v_t^T,          S_{-1} = s0,
// and the final state written to s_last.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_wkv/kernel.py
// `wkv6_padded` / `_wkv_kernel` (K10).  The TPU kernel keeps the [hd, hd]
// state as one VMEM tile and runs each step as rank-1 VPU outer products
// over a sequential time-block grid dimension, with S padded to a block
// multiple (padded steps w = 1, k = 0 leave the state unchanged).  Here one
// block owns one (b, h) for the whole sequence and thread j owns column j
// of the state, S[:, j], in registers (hd floats).  Per step the block
// stages r_t, k_t, w_t (hd floats each) in shared memory, double-buffered
// so one barrier per step suffices; thread j then computes
//   kv_i  = k_i * v_j
//   out_j = sum_i r_i * (S_ij + u_i * kv_i)
//   S_ij  = w_i * S_ij + kv_i
// — the reference's operations in its order, all reads of shared memory
// being broadcasts.  Exact S: there are no padded steps to leak into
// s_last.  Tensors stay in the model layout ([B, S, H, hd]; u [H, hd]; s0 /
// s_last [B, H, hd, hd]), so no transposed copies are made around the
// call.
//
// What bounds it on an H100: bytes, narrowly.  Each step does 4 hd^2 fp32
// operations per (b, h) against 5 hd fp32 values moved: at rwkv6-1.6b's
// width (H = 32, hd = 64) 4 * 32 * 4096 = 0.52 MFLOP a token, 7.8 us a
// thousand tokens at the 67 TFLOP/s fp32 (non-tensor) peak, while its
// bytes (r, k, v, w in, out out: 20 * 2048 = 41 KB a token) take 12 us at
// 3.35 TB/s.  This first kernel has B * H blocks
// of hd threads (32 blocks of 64 threads at batch 1, a quarter of the SMs,
// two warps each) and a serial step chain, so it is latency-bound.  Several
// heads per block and cp.async staging of the next steps' rows are later
// work (ROADMAP queue 2).
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ s_last, int S,
            int H) {
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j = threadIdx.x;
  const int64_t state0 = static_cast<int64_t>(blockIdx.x) * HD * HD;

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = s0[state0 + i * HD + j];
  us[j] = u[h * HD + j];

  // row (b, t, h) of a [B, S, H, HD] tensor
  auto row = [&](int t) {
    return ((static_cast<int64_t>(b) * S + t) * H + h) * HD;
  };
  for (int t = 0; t < S; ++t) {
    const int buf = t & 1;
    const int64_t o = row(t);
    rs[buf][j] = r[o + j];
    ks[buf][j] = k[o + j];
    ws[buf][j] = w[o + j];
    const float vj = v[o + j];
    // one barrier per step: buffer `buf` was last read in step t - 2,
    // which every thread finished before passing step t - 1's barrier
    __syncthreads();
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = ks[buf][i] * vj;
      acc += rs[buf][i] * (st[i] + us[i] * kv);
      st[i] = ws[buf][i] * st[i] + kv;
    }
    out[o + j] = acc;
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_last[state0 + i * HD + j] = st[i];
}

template <int HD>
int wkv6_launch_hd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* out,
                   void* s_last, int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<HD><<<B * H, HD, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(s_last), S, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// r, k, v, w, out: [B, S, H, hd] fp32; u: [H, hd]; s0, s_last:
// [B, H, hd, hd]; all contiguous.  hd in {16, 32, 64}.  Returns the
// cudaError_t of the launch (0 = queued).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* s0,
                           void* out, void* s_last, int B, int S, int H,
                           int hd, void* stream) {
  using namespace repro_torch;
  if (B < 1 || S < 1 || H < 1 || static_cast<int64_t>(B) * H > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return wkv6_launch_hd<16>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    case 32:
      return wkv6_launch_hd<32>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    case 64:
      return wkv6_launch_hd<64>(r, k, v, w, u, s0, out, s_last, B, S, H, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
