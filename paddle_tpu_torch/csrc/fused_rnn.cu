// The fused tanh-RNN time loop, forward (kernel H) and backward (kernel I).
//
// Replaces: paddle_tpu/ops/pallas_rnn.py `_fwd_kernel` (H, launched by
// `_run_fwd`) and `_bwd_kernel` (I, launched by `_fused_bwd`), the two
// Pallas TPU kernels under the `fused_simple_rnn` custom_vjp.
//
// What H computes, for x_proj [T, B, H] (f32 or bf16), w_hh [H, H] (f32
// or bf16), h0 [B, H] f32 and bounds [B, 2] int32 (row b is live at steps
// start <= t < end):
//   h' = tanh(x_proj[t] + round_w(h) @ w_hh)   (products summed in f32);
//   a masked step carries h through; hs[t] = h, f32 whatever x_proj's
//   dtype.
//
// What I computes, walking t from T-1 to 0 with the f32 carry dh (from
// dh_last), from the saved stream alone (no recomputation): dh = dhs[t] +
// carry; dz = masked ? 0 : dh (1 - hs[t]^2); dxp[t] = dz (x_proj's
// dtype); carry <- masked ? dh : round_w(dz) @ w_hh^T; dW_hh +=
// round_w(hprev)^T @ round_w(dz), hprev = hs[t-1] (h0 at t=0). Outputs
// dxp, dW_hh [H, H] f32 and dh0 [B, H] f32.
//
// What bounds them on an H100: operations. At T=100, B=64, H=512 in f32
// H does 2 T B H H = 3.36 GFLOP (0.050 ms at the 67 TFLOP/s of the f32
// CUDA cores) against ~27 MB; I two such products.
//
// H's design: the GRU forward's (fused_gru.cu) with one gate. CTA k owns
// hb hidden units and their columns of w_hh ([H][hb], resident in shared
// memory); a thread carries up to kMaxPairs (row, unit) pairs and their
// f32 carries in registers; h crosses CTAs through a ping-pong buffer [2,
// B, H] with one grid barrier per step. Tiles move through shared memory
// by cp.async, read at L2 only. A shape whose slices do not fit is
// refused by the host.
//
// I's design: E's and G's (fused_lstm.cu, fused_gru.cu) without their
// gates phase, since dz needs only the saved stream. Of I's two products
// only dz @ w_hh^T feeds the recurrence, so it runs in two launches:
//   1. rnn_bwd_loop, one cooperative launch of time_loop.cuh's
//      backward_loop_kernel with I's cell (RnnCell below), over row groups
//      x unit groups: each step a CTA computes its pairs' dz, writes it
//      to dxp and, rounded to w_hh's dtype, to the operand scratch [T, B,
//      H], passes its row group's barrier, and multiplies its rows of the
//      operand by its rows of w_hh (resident where they fit, else read
//      through L2). Its barrier counters are zeroed by a memset on the
//      stream just before it (E and G zero theirs in their gates phase),
//      a device operation of its own that the wrapper counts.
//   2. rnn_bwd_dw: dW_hh = round_w(hprev)^T @ operand, split over the T*B
//      rows, the parts summed in a fixed order (bitwise repeatable).

#include "time_loop.cuh"

namespace cg = cooperative_groups;
using namespace time_loop;

namespace {

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    rnn_fwd_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                   const float* __restrict__ h0,
                   const int* __restrict__ bounds, float* __restrict__ hs,
                   float* hbuf, int Tn, int B, int H, int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                    // 16-byte tile rows
  float* ws = smem;                         // [H][hb]
  float* tile = smem + H * hb;              // [B][ld]
  const int j0 = blockIdx.x * hb;
  for (int e = threadIdx.x; e < H * hb; e += blockDim.x)
    ws[e] = load_f(w + (size_t)(e / hb) * H + j0 + e % hb);
  int pb[kMaxPairs], pu[kMaxPairs];
  const int np = my_pairs(pb, pu, B, hb);
  float hc[kMaxPairs];
  int lo[kMaxPairs], hi[kMaxPairs];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    hc[n] = n < np ? h0[pb[n] * H + j0 + pu[n]] : 0.f;
    lo[n] = bounds[2 * pb[n]];
    hi[n] = bounds[2 * pb[n] + 1];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * H;
  const TW* wtype = nullptr;

  for (int t = 0; t < Tn; ++t) {
    const float* hin = t == 0 ? h0 : hbuf + ((t - 1) & 1) * plane;
    float* hout = hbuf + (t & 1) * plane;
    float acc[kMaxPairs];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) acc[n] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      stage_tile(tile, ld, hin, H, B, k0, kw);
      __syncthreads();
      for (int kk = 0; kk < kw; kk += 4) {
#pragma unroll
        for (int n = 0; n < kMaxPairs; ++n) {
          if (n >= np) break;
          const float4 hv =
              *reinterpret_cast<const float4*>(tile + pb[n] * ld + kk);
          const float* wc = ws + (k0 + kk) * hb + pu[n];
          acc[n] = fmaf(round_as(hv.x, wtype), wc[0], acc[n]);
          acc[n] = fmaf(round_as(hv.y, wtype), wc[hb], acc[n]);
          acc[n] = fmaf(round_as(hv.z, wtype), wc[2 * hb], acc[n]);
          acc[n] = fmaf(round_as(hv.w, wtype), wc[3 * hb], acc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], j = j0 + pu[n];
      const size_t o = ((size_t)t * B + b) * H + j;
      const float h = tanhf(load_f(xp + o) + acc[n]);
      if (lo[n] <= t && t < hi[n]) hc[n] = h;
      hs[o] = hc[n];
      hout[b * H + j] = hc[n];
    }
    grid.sync();
  }
}

// -- I: the serial loop (time_loop.cuh backward_loop_kernel) -----------------

// I's cell: the f32 carry dh of one (row, unit) pair. dz comes from the
// saved f32 stream (no gates phase): dz = dh (1 - h^2).
template <typename T, typename TWt>
struct RnnCell {
  using TW = TWt;
  struct Step {       // the step's inputs, loaded a step ahead
    float h, dh;      // hs[t], dhs[t]
  };
  struct Carry {
    float dh;
  };
  const float* hs;         // [T*B][H]
  const float* dhs;        // [T*B][H]
  const float* dh_last;    // [B][H]
  T* dxp;                  // [T*B][H]
  float* dh0;
  int B, H;

  __device__ __forceinline__ Carry init(int b, int j) const {
    return {dh_last[b * H + j]};
  }
  __device__ __forceinline__ Step fetch(int t, int b, int j) const {
    const size_t o = ((size_t)t * B + b) * H + j;
    return {hs[o], dhs[o]};
  }
  // dz (zero at a masked step) into dxp, and rounded as the operand
  __device__ __forceinline__ void step(const Step& s, Carry& c, bool live,
                                       bool store, size_t row, int j,
                                       TW* op) const {
    const float dh = s.dh + c.dh;
    if (store) {
      const float dz = live ? dh * (1.f - s.h * s.h) : 0.f;
      store_f(dxp + row * H + j, dz);
      store_cg(op + j, round_as(dz, op));
    }
    c.dh = dh;
  }
  // a masked step passes dh through
  __device__ __forceinline__ void carry(Carry& c, float back,
                                        bool live) const {
    if (live) c.dh = back;
  }
  __device__ __forceinline__ void finish(const Carry& c, int b,
                                         int j) const {
    dh0[b * H + j] = c.dh;
  }
};

}  // namespace

extern "C" int rnn_device_limits(int* out) { return device_limits(out); }

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. Grid H/hb CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory, tiles of
// kt columns (kt % 4 == 0). Returns the launch's cudaError_t.
extern "C" int rnn_fwd(int x_dtype, int w_dtype, const void* xp,
                       const void* w, const void* h0, const void* bounds,
                       void* hs, void* hbuf, int Tn, int B, int H, int hb,
                       int kt, int threads, long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const T* a_xp = static_cast<const T*>(xp);
    const TW* a_w = static_cast<const TW*>(w);
    const float* a_h0 = static_cast<const float*>(h0);
    const int* a_bounds = static_cast<const int*>(bounds);
    float* a_hs = static_cast<float*>(hs);
    float* a_hbuf = static_cast<float*>(hbuf);
    void* args[] = {&a_xp, &a_w, &a_h0, &a_bounds, &a_hs, &a_hbuf,
                    &Tn,   &B,   &H,    &hb,       &kt};
    return launch_coop(rnn_fwd_kernel<T, TW>, H / hb, threads, (size_t)smem,
                       args, static_cast<cudaStream_t>(stream));
  });
}

// I in two phases on `stream`, each returning its cudaError_t. The loop
// (a memset of its row groups' barrier counters, then one cooperative
// launch) writes dxp and the operand round_w(dz) [T*B][ldo]. x_dtype
// selects dxp's type (the loop reads no x_proj).
extern "C" int rnn_bwd_loop(int x_dtype, int w_dtype, int ut, int rep,
                            int resident, const void* hs, const void* dhs,
                            const void* dh_last, const void* bounds,
                            const void* w, void* dxp, void* opnd, int ldo,
                            void* dh0, void* counters, int Tn, int B, int H,
                            int hb, int br, int cw, int threads,
                            long long smem, void* stream) {
  cudaError_t err = cudaMemsetAsync(
      counters, 0, sizeof(unsigned) * ((B + br - 1) / br),
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const RnnCell<T, TW> cell{
        static_cast<const float*>(hs), static_cast<const float*>(dhs),
        static_cast<const float*>(dh_last), static_cast<T*>(dxp),
        static_cast<float*>(dh0), B, H};
    const LoopArgs<TW> a{static_cast<const TW*>(w), static_cast<TW*>(opnd),
                         static_cast<const int*>(bounds),
                         static_cast<unsigned*>(counters),
                         ldo, Tn, B, H, H, hb, br, cw};
    return launch_loop(cell, a, ut, rep, resident, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream));
  });
}

// dW_hh = round_w(hprev)^T @ operand over the T*B rows, split and summed
// in a fixed order (time_loop.cuh launch_dw)
extern "C" int rnn_bwd_dw(int w_dtype, const void* hs, const void* h0,
                          const void* opnd, int ldo, void* part, void* dw,
                          int Tn, int B, int H, int splits, int kchunk,
                          int* launched, void* stream) {
  return dispatch_dtypes(0, w_dtype, [&](auto*, auto* wt) {
    using TW = std::remove_pointer_t<decltype(wt)>;
    return launch_dw<float, TW>(hs, h0, opnd, ldo, part, dw, Tn * B, B, H,
                                H, splits, kchunk, launched,
                                static_cast<cudaStream_t>(stream));
  });
}
