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
// H's design: the serial forward loop of time_loop.cuh
// (`forward_loop_kernel`) with H's cell (RnnFwdCell below, one gate
// column), one cooperative launch over row groups x unit groups, as F and
// D run. CTA (g, k) owns br rows and hb units; its units' columns of w_hh
// are resident in shared memory as rows [hb][H + 4] f32, transposed at
// load (read through L2 from a w_hh^T scratch where they do not fit, from
// H=2816 at B=64). Each step a CTA multiplies its rows of round_w(h_{t-1})
// (an operand plane in w_hh's dtype, staged by cp.async with the next
// chunk in flight) by those rows in thread tiles that reuse each weight
// float4 across 4 rows, runs its pairs' cells, writes hs[t] and
// round_w(h_t) into the other plane and passes its row group's barrier:
// batch rows never interact, so no CTA waits for the whole grid. At T=100,
// B=64, H=512 that is I's grid: 16 row groups x 8 unit groups, 4 rows x 64
// units per CTA. The barrier counters are zeroed by a memset on the stream
// just before the launch, a device operation the wrapper counts.
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

using namespace time_loop;

namespace {

// -- H: the serial forward loop (time_loop.cuh forward_loop_kernel) -------

// H's cell: the f32 carry h of one (row, unit) pair
template <typename T, typename TWt>
struct RnnFwdCell {
  using TW = TWt;
  static constexpr int kOut = 1;
  struct Step {       // x_proj, loaded a step ahead
    float x;
  };
  struct Carry {
    float h;
  };
  const T* xp;        // [T*B][H]
  const float* h0;    // [B][H]
  float* hs;          // [T*B][H]
  int B, H;

  __device__ __forceinline__ Carry init(int b, int j) const {
    return {h0[b * H + j]};
  }
  __device__ __forceinline__ float operand(const Carry& c) const {
    return c.h;
  }
  __device__ __forceinline__ Step fetch(int t, int b, int j) const {
    return {load_f(xp + ((size_t)t * B + b) * H + j)};
  }
  // g = the sum of round_w(h) @ w_hh for the pair's unit
  __device__ __forceinline__ void step(const Step& s, const float (&g)[1],
                                       Carry& c, bool live, bool store,
                                       size_t row, int j) const {
    const float h = tanhf(s.x + g[0]);
    if (live) c.h = h;
    if (store) hs[row * H + j] = c.h;
  }
};

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

// H on `stream`: a memset of the barrier counters [row groups + 1], then
// the forward loop over row groups x unit groups for the host's geometry
// (ut, rep, resident, hb, br, cw, threads, smem); opnd [2][B][ldo] in
// w_hh's dtype; wt [H][H] in w_hh's dtype where the columns are not
// resident (else unused). x_dtype / w_dtype: 0 = float32, 1 = bfloat16.
// Returns the first cudaError_t.
extern "C" int rnn_fwd(int x_dtype, int w_dtype, int ut, int rep,
                       int resident, const void* xp, const void* w, void* wt,
                       const void* h0, const void* bounds, void* hs,
                       void* opnd, int ldo, void* counters, int Tn, int B,
                       int H, int hb, int br, int cw, int threads,
                       long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wtt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wtt)>;
    const RnnFwdCell<T, TW> cell{static_cast<const T*>(xp),
                                 static_cast<const float*>(h0),
                                 static_cast<float*>(hs), B, H};
    const ForwardArgs<TW> a{static_cast<const TW*>(w), static_cast<TW*>(wt),
                            static_cast<TW*>(opnd),
                            static_cast<const int*>(bounds),
                            static_cast<unsigned*>(counters),
                            ldo, Tn, B, H, hb, br, cw};
    return launch_forward(cell, a, ut, rep, resident, threads, (size_t)smem,
                          static_cast<cudaStream_t>(stream));
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
