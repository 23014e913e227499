// The fused LSTM time loop, forward (kernel D) and backward (kernel E).
//
// Replaces: paddle_tpu/ops/pallas_lstm.py `_fwd_kernel` (D, launched by
// `_fwd`) and `_bwd_kernel` (E, launched by `_fused_bwd`), the two Pallas
// TPU kernels under the `fused_lstm` custom_vjp.
//
// What D computes, for x_proj [T, B, 4H] (the hoisted input projection,
// f32 or bf16), w_hh [H, 4H] (f32 or bf16, gate order i, f, g, o), h0/c0
// [B, H] f32 and bounds [B, 2] int32 (row b is live at steps start <= t <
// end):
//   gates = x_proj[t] + round_w(h) @ w_hh   (products summed in f32)
//   c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//   a masked step carries (h, c) through unchanged;
//   hs[t] = h (x_proj's dtype), cs[t] = c (f32).
// round_w rounds an operand to w_hh's dtype, as the TPU kernel feeds
// `h.astype(w_hh.dtype)` to the MXU; the carries stay f32 throughout.
//
// What E computes, walking t from T-1 to 0 with f32 carries dh (from
// dh_last) and dc (from dc_last): hprev = hs[t-1] (h0 at t=0), cprev =
// cs[t-1] (c0 at t=0); the gates recomputed from hprev; dh = dhs[t] + dh;
// dgates [B, 4H] (zero at a masked step) into dxp[t]; dh <- masked ? dh :
// round_w(dgates) @ w_hh^T; dc <- masked ? dc : dc * sig(f); dW_hh +=
// round_w(hprev)^T @ round_w(dgates). Outputs dxp (x_proj's dtype), dW_hh
// [H, 4H] f32, dh0/dc0 [B, H] f32.
//
// What bounds them on an H100: operations. At T=100, B=64, H=512 in f32
// D does 13.4 GFLOP (0.20 ms at the 67 TFLOP/s of the f32 CUDA cores)
// and moves ~82 MB (0.025 ms); E does three such products.
//
// D's design: the serial forward loop of time_loop.cuh
// (`forward_loop_kernel`) with D's cell (LstmFwdCell below), one
// cooperative launch over row groups x unit groups, as F's (batch rows
// never interact, so a CTA waits only for its own row group each step).
// CTA (g, k) owns br rows and hb units; their four gate columns of w_hh
// are resident in shared memory as rows [4][hb][H + 4] f32, transposed at
// load, where they fit (at H=512: 16 units, 132 KB), else read through L2
// from a w_hh^T scratch [4H][H] that the grid writes first. A thread
// carries (h, c) of its pairs in registers: c never leaves the thread.
// Each step a CTA multiplies its rows of round_w(h_{t-1}) (an operand
// plane in w_hh's dtype, exact, staged by cp.async with the next chunk in
// flight) by those rows in thread tiles that reuse each weight float4
// across 4 rows, runs its pairs' cells, writes hs[t], cs[t] and
// round_w(h_t) into the other operand plane and passes its row group's
// barrier. The barrier counters are zeroed by a memset on the stream just
// before the launch, a device operation the wrapper counts.
//
// E's design. On the TPU the grid runs in order, so the Pallas kernel
// does all of a step's work in one grid step. Here a step is a serial
// round trip across the card, and of E's three products only one feeds
// the recurrence: the gates read only hs (saved by D) and x_proj, and
// dW_hh only hprev and the step's rounded dgates. So E runs in three
// launches on the stream:
//   1. lstm_bwd_gates: round_w(hprev) @ w_hh for all T*B rows at once, a
//      tiled product (tile_gemm.cuh) whose columns are permuted to (unit,
//      gate) so that each thread's epilogue adds x_proj and stores the
//      four activations of a unit as one float4: gates [T, B, H, 4] f32.
//   2. lstm_bwd_loop, one cooperative launch of time_loop.cuh's
//      backward_loop_kernel with E's cell (LstmCell below): the serial
//      loop with only the carry's product in it. The grid is row groups x
//      unit groups; CTA (g, k) owns br rows and hb units, keeps only its
//      units' rows of w_hh resident (where they fit; from H=1536 on the
//      loop reads them through L2), and carries (dh, dc) of one pair per
//      thread (two or four where the pairs outnumber the threads) in
//      registers. Each step it computes its pairs' dgates from the stored
//      gates, writes dxp[t] and round_w(dgates) into the operand scratch
//      [T, B, 4H] (w_hh's dtype, exact), passes a barrier of its row
//      group only (the rows of the batch are independent), and multiplies
//      its rows of the operand (cp.async chunks, double-buffered) by its
//      rows of w_hh. The next step's loads are issued before the barrier.
//   3. lstm_bwd_dw: dW_hh = round_w(hprev)^T @ operand, split over the
//      T*B rows to fill the card, the parts summed in a fixed order (no
//      atomics: dW is the same bit for bit every run).
// What is left on the serial path is one product of B x 4H x H per step,
// one group barrier and one L2 trip of the group's operand rows.

#include "time_loop.cuh"

using namespace time_loop;

namespace {

// -- D: the serial forward loop (time_loop.cuh forward_loop_kernel) -------

// D's cell: the f32 carries (h, c) of one (row, unit) pair
template <typename T, typename TWt>
struct LstmFwdCell {
  using TW = TWt;
  static constexpr int kOut = 4;
  struct Step {       // x_proj's four gates, loaded a step ahead
    float xi, xf, xg, xo;
  };
  struct Carry {
    float h, c;
  };
  const T* xp;        // [T*B][4H]
  const float* h0;    // [B][H]
  const float* c0;
  T* hs;              // [T*B][H]
  float* cs;
  int B, H;

  __device__ __forceinline__ Carry init(int b, int j) const {
    return {h0[b * H + j], c0[b * H + j]};
  }
  __device__ __forceinline__ float operand(const Carry& c) const {
    return c.h;
  }
  __device__ __forceinline__ Step fetch(int t, int b, int j) const {
    const T* x = xp + ((size_t)t * B + b) * 4 * H + j;
    return {load_f(x), load_f(x + H), load_f(x + 2 * H), load_f(x + 3 * H)};
  }
  // g = the four sums of round_w(h) @ w_hh for the pair's unit
  __device__ __forceinline__ void step(const Step& s, const float (&g)[4],
                                       Carry& c, bool live, bool store,
                                       size_t row, int j) const {
    const float gi = sigmoidf(s.xi + g[0]);
    const float gf = sigmoidf(s.xf + g[1]);
    const float gg = tanhf(s.xg + g[2]);
    const float go = sigmoidf(s.xo + g[3]);
    const float cn = gf * c.c + gi * gg;
    const float hn = go * tanhf(cn);
    if (live) {
      c.c = cn;
      c.h = hn;
    }
    if (store) {
      store_f(hs + row * H + j, c.h);
      cs[row * H + j] = c.c;
    }
  }
};

// -- E, phase 1: the gates of every step, in parallel ------------------------

// gates[m][u] = (sig(i), sig(f), tanh(g), sig(o)) of row m = t*B + b and
// unit u, from x_proj and round_w(hprev) @ w_hh. Block (0, 0) also zeroes
// the loop's group-barrier counters.
template <typename T, typename TW>
__global__ void __launch_bounds__(tile_gemm::kThreads)
    lstm_bwd_gates_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                          const float* __restrict__ h0,
                          const T* __restrict__ hs, float* __restrict__ gates,
                          unsigned* __restrict__ counters, int n_groups,
                          int M, int B, int H) {
  __shared__ __align__(16) tile_gemm::Smem sm;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < n_groups)
    counters[threadIdx.x] = 0;
  const int n0 = blockIdx.x * tile_gemm::kBN, m0 = blockIdx.y * tile_gemm::kBM;
  const Hprev<T, TW, true> la{hs, h0, M, B, H};
  const GateCols<TW, 4> lb{w, H};
  float acc[8][8];
  tile_gemm::product(acc, sm, la, lb, m0, n0, 0, H);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, G = 4 * H;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int m = m0 + tile_gemm::out_index(ty, ii);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = (n0 + tile_gemm::out_index(tx, 4 * h)) / 4;
      if (u >= H) continue;
      const T* x = xp + (size_t)m * G + u;
      const float* p = &acc[ii][4 * h];
      *reinterpret_cast<float4*>(gates + ((size_t)m * H + u) * 4) =
          make_float4(sigmoidf(load_f(x) + p[0]),
                      sigmoidf(load_f(x + H) + p[1]),
                      tanhf(load_f(x + 2 * H) + p[2]),
                      sigmoidf(load_f(x + 3 * H) + p[3]));
    }
  }
}

// -- E, phase 2: the serial loop (time_loop.cuh backward_loop_kernel) -------

// E's cell: the f32 carries (dh, dc) of one (row, unit) pair
template <typename T, typename TWt>
struct LstmCell {
  using TW = TWt;
  struct Step {       // the step's inputs, loaded a step ahead
    float4 g;         // i, f, g, o
    float c, cprev, dh;
  };
  struct Carry {
    float dh, dc;
  };
  const float* gates;      // [T*B][H][4]
  const float* cs;         // [T*B][H]
  const float* c0;         // [B][H]
  const T* dhs;            // [T*B][H]
  const float* dh_last;    // [B][H]
  const float* dc_last;
  T* dxp;                  // [T*B][4H]
  float* dh0;
  float* dc0;
  int B, H;

  __device__ __forceinline__ Carry init(int b, int j) const {
    return {dh_last[b * H + j], dc_last[b * H + j]};
  }
  __device__ __forceinline__ Step fetch(int t, int b, int j) const {
    const size_t o = ((size_t)t * B + b) * H + j;
    Step s;
    s.g = *reinterpret_cast<const float4*>(gates + o * 4);
    s.c = cs[o];
    s.cprev = t > 0 ? cs[o - (size_t)B * H] : c0[b * H + j];
    s.dh = load_f(dhs + o);
    return s;
  }
  // dgates (zero at a masked step) into dxp and, rounded, the operand;
  // carry.dh <- dh, and carry.dc <- dc * sig(f) at a live step
  __device__ __forceinline__ void step(const Step& s, Carry& c, bool live,
                                       bool store, size_t row, int j,
                                       TW* op) const {
    const float gi = s.g.x, gf = s.g.y, gg = s.g.z, go = s.g.w;
    const float tc = tanhf(s.c);
    const float dh = s.dh + c.dh;
    const float dc = c.dc + dh * go * (1.f - tc * tc);
    float d[4] = {dc * gg * gi * (1.f - gi), dc * s.cprev * gf * (1.f - gf),
                  dc * gi * (1.f - gg * gg), dh * tc * go * (1.f - go)};
    if (store) {
      const int G = 4 * H;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (!live) d[g] = 0.f;
        store_f(dxp + row * G + g * H + j, d[g]);
        store_cg(op + g * H + j, round_as(d[g], op));
      }
    }
    c.dh = dh;
    if (live) c.dc = dc * gf;
  }
  // a masked step passes dh through
  __device__ __forceinline__ void carry(Carry& c, float back,
                                        bool live) const {
    if (live) c.dh = back;
  }
  __device__ __forceinline__ void finish(const Carry& c, int b,
                                         int j) const {
    dh0[b * H + j] = c.dh;
    dc0[b * H + j] = c.dc;
  }
};

}  // namespace

extern "C" int lstm_device_limits(int* out) { return device_limits(out); }

// D on `stream`: a memset of the barrier counters [row groups + 1], then
// the forward loop over row groups x unit groups for the host's geometry
// (ut, rep, resident, hb, br, cw, threads, smem); opnd [2][B][ldo] in
// w_hh's dtype; wt [4H][H] in w_hh's dtype where the gate columns are not
// resident (else unused). x_dtype / w_dtype: 0 = float32, 1 = bfloat16.
// Returns the first cudaError_t.
extern "C" int lstm_fwd(int x_dtype, int w_dtype, int ut, int rep,
                        int resident, const void* xp, const void* w, void* wt,
                        const void* h0, const void* c0, const void* bounds,
                        void* hs, void* cs, void* opnd, int ldo,
                        void* counters, int Tn, int B, int H, int hb, int br,
                        int cw, int threads, long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wtt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wtt)>;
    const LstmFwdCell<T, TW> cell{
        static_cast<const T*>(xp),     static_cast<const float*>(h0),
        static_cast<const float*>(c0), static_cast<T*>(hs),
        static_cast<float*>(cs),       B,
        H};
    const ForwardArgs<TW> a{static_cast<const TW*>(w), static_cast<TW*>(wt),
                            static_cast<TW*>(opnd),
                            static_cast<const int*>(bounds),
                            static_cast<unsigned*>(counters),
                            ldo, Tn, B, H, hb, br, cw};
    return launch_forward(cell, a, ut, rep, resident, threads, (size_t)smem,
                          static_cast<cudaStream_t>(stream));
  });
}

// E in three launches on `stream`, each returning its cudaError_t.
// x_dtype / w_dtype: 0 = float32, 1 = bfloat16.
//
// Phase 1: gates [T*B, H, 4] f32 from x_proj, w_hh, h0 and hs; zeroes
// counters[0 .. n_groups).
extern "C" int lstm_bwd_gates(int x_dtype, int w_dtype, const void* xp,
                              const void* w, const void* h0, const void* hs,
                              void* gates, void* counters, int n_groups,
                              int Tn, int B, int H, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const int M = Tn * B;
    const dim3 grid((4 * H + tile_gemm::kBN - 1) / tile_gemm::kBN,
                    (M + tile_gemm::kBM - 1) / tile_gemm::kBM);
    lstm_bwd_gates_kernel<T, TW>
        <<<grid, tile_gemm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(xp), static_cast<const TW*>(w),
            static_cast<const float*>(h0), static_cast<const T*>(hs),
            static_cast<float*>(gates), static_cast<unsigned*>(counters),
            n_groups, M, B, H);
    return cudaGetLastError();
  });
}

// Phase 2: one cooperative launch of (B / br row groups) x (H / hb unit
// groups) CTAs of `threads` threads, thread tiles of `ut` units x 4 *
// `rep` rows, w_hh's rows resident in shared memory when `resident`,
// operand chunks of cw columns, `smem` bytes of dynamic shared memory;
// writes dxp, the operand opnd [T*B, ldo] (w_hh's dtype), dh0 and dc0.
extern "C" int lstm_bwd_loop(int x_dtype, int w_dtype, int ut, int rep,
                             int resident, const void* gates, const void* c0,
                             const void* bounds, const void* cs,
                             const void* dhs, const void* dh_last,
                             const void* dc_last, const void* w, void* dxp,
                             void* opnd, int ldo, void* dh0, void* dc0,
                             void* counters, int Tn, int B, int H, int hb,
                             int br, int cw, int threads, long long smem,
                             void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const LstmCell<T, TW> cell{
        static_cast<const float*>(gates),   static_cast<const float*>(cs),
        static_cast<const float*>(c0),      static_cast<const T*>(dhs),
        static_cast<const float*>(dh_last), static_cast<const float*>(dc_last),
        static_cast<T*>(dxp),               static_cast<float*>(dh0),
        static_cast<float*>(dc0),           B,
        H};
    const LoopArgs<TW> a{static_cast<const TW*>(w), static_cast<TW*>(opnd),
                         static_cast<const int*>(bounds),
                         static_cast<unsigned*>(counters),
                         ldo, Tn, B, H, 4 * H, hb, br, cw};
    return launch_loop(cell, a, ut, rep, resident, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream));
  });
}

// Phase 3: dw [H, 4H] f32 = round_w(hprev)^T @ opnd, split `splits` ways
// over the T*B rows (kchunk rows each; part [splits, H, 4H] f32 scratch);
// *launched = the kernels it launched.
extern "C" int lstm_bwd_dw(int x_dtype, int w_dtype, const void* hs,
                           const void* h0, const void* opnd, int ldo,
                           void* part, void* dw, int Tn, int B, int H,
                           int splits, int kchunk, int* launched,
                           void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    return launch_dw<T, TW>(hs, h0, opnd, ldo, part, dw, Tn * B, B, H, 4 * H,
                            splits, kchunk, launched,
                            static_cast<cudaStream_t>(stream));
  });
}
