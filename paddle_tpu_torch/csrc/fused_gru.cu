// The fused GRU time loop, forward (kernel F) and backward (kernel G).
//
// Replaces: paddle_tpu/ops/pallas_gru.py `_fwd_kernel` (F, launched by
// `_fwd`) and `_bwd_kernel` (G, launched by `_fused_bwd`), the two Pallas
// TPU kernels under the `fused_gru` custom_vjp.
//
// What F computes, for x_proj [T, B, 3H] (the hoisted input projection,
// f32 or bf16, gate order r, z, n), w_hh [H, 3H] (f32 or bf16), h0 [B, H]
// f32 and bounds [B, 2] int32 (row b is live at steps start <= t < end):
//   [hr, hz, hn] = round_w(h) @ w_hh           (products summed in f32)
//   r = sig(xr + hr);  z = sig(xz + hz);  n = tanh(xn + r * hn)
//   h' = (1 - z) n + z h;  a masked step carries h through unchanged;
//   hs[t] = h, f32 whatever x_proj's dtype.
// round_w rounds an operand to w_hh's dtype, as the TPU kernel feeds
// `h.astype(w_hh.dtype)` to the MXU; the carry stays f32 throughout.
//
// What G computes, walking t from T-1 to 0 with the f32 carry dh (from
// dh_last): hprev = hs[t-1] (h0 at t=0); r, z, n and hn recomputed from
// hprev; dh = dhs[t] + carry; dz = dh (hprev - n), dn = dh (1 - z),
// dgn = dn (1 - n^2), dgz = dz z (1 - z), dgr = dgn hn r (1 - r);
// dxp[t] = masked ? 0 : [dgr, dgz, dgn] (x_proj's dtype); dhp = the same
// with dgn r in the n column, rounded to w_hh's dtype; carry <- masked ?
// dh : dh z + dhp @ w_hh^T; dW_hh += round_w(hprev)^T @ dhp. Outputs dxp,
// dW_hh [H, 3H] f32 and dh0 [B, H] f32.
//
// What bounds them on an H100: operations. At the seq2seq encoder's T=30,
// B=64, H=512 in f32, F does 2 T B H 3H = 3.02 GFLOP (0.045 ms at the 67
// TFLOP/s of the f32 CUDA cores) against ~18 MB; G three such products.
//
// F's design: the serial forward loop of time_loop.cuh
// (`forward_loop_kernel`) with F's cell (GruFwdCell below), one
// cooperative launch over row groups x unit groups (the backward loops'
// grid: batch rows never interact, so a CTA waits only for its own row
// group each step). CTA (g, k) owns br rows and hb units; their three gate
// columns of w_hh are resident in shared memory as rows [3][hb][H + 4],
// transposed at load (read through L2 from a w_hh^T scratch where they do
// not fit). Each step a CTA multiplies its rows of round_w(h_{t-1}) (an
// operand plane in w_hh's dtype, exact, staged by cp.async with the next
// chunk in flight) by those rows in thread tiles that reuse each weight
// float4 across 4 rows, runs its pairs' cells, writes hs[t] and
// round_w(h_t) into the other operand plane and passes its row group's
// barrier. The barrier counters are zeroed by a memset on the stream just
// before the launch, a device operation the wrapper counts.
//
// G's design: the LSTM backward's (E in fused_lstm.cu), in three launches.
// Of G's three products only dhp @ w_hh^T feeds the recurrence.
//   1. gru_bwd_gates: round_w(hprev) @ w_hh for all T*B rows at once (a
//      tiled product, columns permuted to (unit, gate) with a zero fourth
//      lane that the product skips), whose epilogue stores (r, z, n, hn)
//      of each unit as one float4: gates [T, B, H, 4] f32 (hn is needed
//      for dgr).
//   2. gru_bwd_loop, one cooperative launch of time_loop.cuh's
//      backward_loop_kernel with G's cell (GruCell below), over row groups
//      x unit groups: each step a CTA computes its pairs' dxp and dhp from
//      the stored gates, hprev and dhs, writes dhp (w_hh's dtype, exact)
//      into the operand scratch [T, B, 3H], passes its row group's
//      barrier, and multiplies its rows of dhp by its rows of w_hh
//      (resident where they fit, else read through L2).
//   3. gru_bwd_dw: dW_hh = round_w(hprev)^T @ dhp, split over the T*B rows,
//      the parts summed in a fixed order.

#include "time_loop.cuh"

using namespace time_loop;

namespace {

// -- F: the serial forward loop (time_loop.cuh forward_loop_kernel) -------

// F's cell: the f32 carry h of one (row, unit) pair
template <typename T, typename TWt>
struct GruFwdCell {
  using TW = TWt;
  static constexpr int kOut = 3;
  struct Step {       // x_proj's three gates, loaded a step ahead
    float xr, xz, xn;
  };
  struct Carry {
    float h;
  };
  const T* xp;        // [T*B][3H]
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
    const T* x = xp + ((size_t)t * B + b) * 3 * H + j;
    return {load_f(x), load_f(x + H), load_f(x + 2 * H)};
  }
  // g = the three sums of round_w(h) @ w_hh for the pair's unit
  __device__ __forceinline__ void step(const Step& s, const float (&g)[3],
                                       Carry& c, bool live, bool store,
                                       size_t row, int j) const {
    const float r = sigmoidf(s.xr + g[0]);
    const float z = sigmoidf(s.xz + g[1]);
    const float n = tanhf(s.xn + r * g[2]);
    const float h = (1.f - z) * n + z * c.h;
    if (live) c.h = h;
    if (store) hs[row * H + j] = c.h;
  }
};

// -- G, phase 1: the gates of every step, in parallel ------------------------

// gates[m][u] = (r, z, n, hn) of row m = t*B + b and unit u; block (0, 0)
// also zeroes the loop's group-barrier counters
template <typename T, typename TW>
__global__ void __launch_bounds__(tile_gemm::kThreads)
    gru_bwd_gates_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                         const float* __restrict__ h0,
                         const float* __restrict__ hs,
                         float* __restrict__ gates,
                         unsigned* __restrict__ counters, int n_groups, int M,
                         int B, int H) {
  __shared__ __align__(16) tile_gemm::Smem sm;
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x < n_groups)
    counters[threadIdx.x] = 0;
  const int n0 = blockIdx.x * tile_gemm::kBN, m0 = blockIdx.y * tile_gemm::kBM;
  const Hprev<float, TW, true> la{hs, h0, M, B, H};
  const GateCols<TW, 3> lb{w, H};
  float acc[8][8];
  tile_gemm::product<3>(acc, sm, la, lb, m0, n0, 0, H);  // no 4th lane
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, G = 3 * H;
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
      const float r = sigmoidf(load_f(x) + p[0]);
      const float z = sigmoidf(load_f(x + H) + p[1]);
      const float n = tanhf(load_f(x + 2 * H) + r * p[2]);
      *reinterpret_cast<float4*>(gates + ((size_t)m * H + u) * 4) =
          make_float4(r, z, n, p[2]);
    }
  }
}

// -- G, phase 2: the serial loop (time_loop.cuh backward_loop_kernel) -------

// G's cell: the f32 carry dh of one (row, unit) pair
template <typename T, typename TWt>
struct GruCell {
  using TW = TWt;
  struct Step {       // the step's inputs, loaded a step ahead
    float4 g;         // r, z, n, hn
    float hprev, dh;
  };
  struct Carry {
    float dh, z;      // dh, and the step's z until the product is in
  };
  const float* gates;      // [T*B][H][4]
  const float* hs;         // [T*B][H]
  const float* h0;         // [B][H]
  const float* dhs;        // [T*B][H]
  const float* dh_last;    // [B][H]
  T* dxp;                  // [T*B][3H]
  float* dh0;
  int B, H;

  __device__ __forceinline__ Carry init(int b, int j) const {
    return {dh_last[b * H + j], 0.f};
  }
  __device__ __forceinline__ Step fetch(int t, int b, int j) const {
    const size_t o = ((size_t)t * B + b) * H + j;
    Step s;
    s.g = *reinterpret_cast<const float4*>(gates + o * 4);
    s.hprev = t > 0 ? hs[o - (size_t)B * H] : h0[b * H + j];
    s.dh = dhs[o];
    return s;
  }
  // [dgr, dgz, dgn] (zero at a masked step) into dxp, and the operand dhp
  // = [dgr, dgz, dgn * r] rounded; carry <- (dh, z)
  __device__ __forceinline__ void step(const Step& s, Carry& c, bool live,
                                       bool store, size_t row, int j,
                                       TW* op) const {
    const float r = s.g.x, z = s.g.y, nn = s.g.z, hn = s.g.w;
    const float dh = s.dh + c.dh;
    const float dz = dh * (s.hprev - nn);
    const float dgn = dh * (1.f - z) * (1.f - nn * nn);
    const float dgz = dz * z * (1.f - z);
    const float dgr = dgn * hn * r * (1.f - r);
    if (store) {
      const float d0 = live ? dgr : 0.f, d1 = live ? dgz : 0.f,
                  d2 = live ? dgn : 0.f;
      T* dx = dxp + row * 3 * H + j;
      store_f(dx, d0);
      store_f(dx + H, d1);
      store_f(dx + 2 * H, d2);
      store_cg(op + j, round_as(d0, op));
      store_cg(op + H + j, round_as(d1, op));
      store_cg(op + 2 * H + j, round_as(d2 * r, op));
    }
    c.dh = dh;
    c.z = z;
  }
  // a masked step passes dh through
  __device__ __forceinline__ void carry(Carry& c, float back,
                                        bool live) const {
    if (live) c.dh = c.dh * c.z + back;
  }
  __device__ __forceinline__ void finish(const Carry& c, int b,
                                         int j) const {
    dh0[b * H + j] = c.dh;
  }
};

}  // namespace

extern "C" int gru_device_limits(int* out) { return device_limits(out); }

// F on `stream`: a memset of the barrier counters [row groups + 1], then
// the forward loop over row groups x unit groups for the host's geometry
// (ut, rep, resident, hb, br, cw, threads, smem); opnd [2][B][ldo] in
// w_hh's dtype; wt [3H][H] in w_hh's dtype where the gate columns are not
// resident (else unused). x_dtype / w_dtype: 0 = float32, 1 = bfloat16.
// Returns the first cudaError_t.
extern "C" int gru_fwd(int x_dtype, int w_dtype, int ut, int rep,
                       int resident, const void* xp, const void* w, void* wt,
                       const void* h0, const void* bounds, void* hs,
                       void* opnd, int ldo, void* counters, int Tn, int B,
                       int H, int hb, int br, int cw, int threads,
                       long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wtt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wtt)>;
    const GruFwdCell<T, TW> cell{static_cast<const T*>(xp),
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

// G in three launches on `stream`, each returning its cudaError_t; the
// arguments as lstm_bwd_* (fused_lstm.cu) with 3H gate columns, hs f32
// and no c carry.
extern "C" int gru_bwd_gates(int x_dtype, int w_dtype, const void* xp,
                             const void* w, const void* h0, const void* hs,
                             void* gates, void* counters, int n_groups,
                             int Tn, int B, int H, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const int M = Tn * B;
    const dim3 grid((4 * H + tile_gemm::kBN - 1) / tile_gemm::kBN,
                    (M + tile_gemm::kBM - 1) / tile_gemm::kBM);
    gru_bwd_gates_kernel<T, TW>
        <<<grid, tile_gemm::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(xp), static_cast<const TW*>(w),
            static_cast<const float*>(h0), static_cast<const float*>(hs),
            static_cast<float*>(gates), static_cast<unsigned*>(counters),
            n_groups, M, B, H);
    return cudaGetLastError();
  });
}

extern "C" int gru_bwd_loop(int x_dtype, int w_dtype, int ut, int rep,
                            int resident, const void* gates, const void* h0,
                            const void* bounds, const void* hs,
                            const void* dhs, const void* dh_last,
                            const void* w, void* dxp, void* opnd, int ldo,
                            void* dh0, void* counters, int Tn, int B, int H,
                            int hb, int br, int cw, int threads,
                            long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const GruCell<T, TW> cell{
        static_cast<const float*>(gates), static_cast<const float*>(hs),
        static_cast<const float*>(h0),    static_cast<const float*>(dhs),
        static_cast<const float*>(dh_last), static_cast<T*>(dxp),
        static_cast<float*>(dh0),         B,
        H};
    const LoopArgs<TW> a{static_cast<const TW*>(w), static_cast<TW*>(opnd),
                         static_cast<const int*>(bounds),
                         static_cast<unsigned*>(counters),
                         ldo, Tn, B, H, 3 * H, hb, br, cw};
    return launch_loop(cell, a, ut, rep, resident, threads, (size_t)smem,
                       static_cast<cudaStream_t>(stream));
  });
}

extern "C" int gru_bwd_dw(int w_dtype, const void* hs, const void* h0,
                          const void* opnd, int ldo, void* part, void* dw,
                          int Tn, int B, int H, int splits, int kchunk,
                          int* launched, void* stream) {
  return dispatch_dtypes(0, w_dtype, [&](auto*, auto* wt) {
    using TW = std::remove_pointer_t<decltype(wt)>;
    return launch_dw<float, TW>(hs, h0, opnd, ldo, part, dw, Tn * B, B, H,
                                3 * H, splits, kchunk, launched,
                                static_cast<cudaStream_t>(stream));
  });
}
