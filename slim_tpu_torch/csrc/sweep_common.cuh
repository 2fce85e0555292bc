// Pieces shared by the sweep engines (sweep.cu, sweep_panel.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// per-column register k of column b: regs is (B, 5) in layout 0 (row-major
// sweeps) and (5, B) in layout 1 (coordinate-major); k = l1r, l2r, cap, t0,
// optTol
__device__ __forceinline__ float reg(const float* regs, int layout, int k,
                                     int b, int B) {
  return layout == 0 ? regs[b * 5 + k] : regs[k * B + b];
}

// end of sweep: nit = live at sweep start; a column dies when
// sum(dx^2) < optTol or t0 + 1 >= cap
__global__ void sweep_end_kernel(int layout, const float* __restrict__ live_in,
                                 const float* __restrict__ regs,
                                 const float* __restrict__ dltx,
                                 float* __restrict__ live_out,
                                 float* __restrict__ nit, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float lv = live_in[b];
  const float cap = reg(regs, layout, 2, b, B);
  const float t0 = reg(regs, layout, 3, b, B);
  const float tol = reg(regs, layout, 4, b, B);
  const float keep = (dltx[b] < tol ? 0.0f : 1.0f) *
                     ((t0 + 1.0f) < cap ? 1.0f : 0.0f);
  nit[b] = lv;
  live_out[b] = lv * keep;
}

}  // namespace
