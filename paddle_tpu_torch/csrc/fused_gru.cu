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
// Design: the LSTM kernels' (fused_lstm.cu). The time loop runs inside
// one cooperative launch, as the TPU kernel runs it inside one
// pallas_call. CTA k owns hb hidden units j in [k*hb, (k+1)*hb) and their
// gate columns j, H+j, 2H+j of w_hh, resident in shared memory as [H][hb]
// [4] (the fourth lane zero, so one 16-byte load gives a unit's three
// gates). A thread carries up to kMaxPairs (row, unit) pairs and their f32
// carries in registers: the cell update is elementwise in j. Every CTA
// needs all of h_{t-1} for its products, so each step writes its units of
// h into a ping-pong buffer [2, B, H] and ends with one grid barrier. G
// also keeps its units' rows of w_hh (for dhp @ w_hh^T) and their dW
// columns (each column has one owner: no atomics) resident; because hs is
// known before G starts, its gate recomputation needs no exchange, and
// only the dhp row block [B, 3H] crosses CTAs each step, through a second
// ping-pong buffer. Tiles move through shared memory by cp.async, as wide
// as shared memory allows beside the resident slices (the host picks the
// width; all of h at once at H=512, and G then reuses its hprev tile for
// dW). A shape whose slices do not fit is refused by the host. Later work:
// tensor-core products, register tiles over rows.

#include "time_loop.cuh"

namespace cg = cooperative_groups;
using namespace time_loop;

namespace {

// acc[n][g] += sum_k round_w(tile[b_n][k]) * ws[k0+k][u_n][g] over a
// staged tile of kw columns, for the three gates g of unit u_n
template <typename TW>
__device__ __forceinline__ void gate_products(
    float (&acc)[kMaxPairs][3], const float* tile, int ld, const float* ws,
    const int (&pb)[kMaxPairs], const int (&pu)[kMaxPairs], int np, int k0,
    int kw, int hb, const TW* wtype) {
  for (int kk = 0; kk < kw; kk += 4) {
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const float4 hv =
          *reinterpret_cast<const float4*>(tile + pb[n] * ld + kk);
      const float hvs[4] = {round_as(hv.x, wtype), round_as(hv.y, wtype),
                            round_as(hv.z, wtype), round_as(hv.w, wtype)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = *reinterpret_cast<const float4*>(
            ws + ((k0 + kk + q) * hb + pu[n]) * 4);
        acc[n][0] = fmaf(hvs[q], wv.x, acc[n][0]);
        acc[n][1] = fmaf(hvs[q], wv.y, acc[n][1]);
        acc[n][2] = fmaf(hvs[q], wv.z, acc[n][2]);
      }
    }
  }
}

// ws[k][u][g] = w_hh[k, g*H + j0 + u] for g < 3, zero for g = 3
template <typename TW>
__device__ __forceinline__ void load_gate_columns(float* ws, const TW* w,
                                                  int H, int hb, int j0) {
  for (int e = threadIdx.x; e < 4 * H * hb; e += blockDim.x) {
    const int k = e / (4 * hb), u = (e / 4) % hb, g = e % 4;
    ws[e] = g < 3 ? load_f(w + (size_t)k * 3 * H + g * H + j0 + u) : 0.f;
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    gru_fwd_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                   const float* __restrict__ h0,
                   const int* __restrict__ bounds, float* __restrict__ hs,
                   float* hbuf, int Tn, int B, int H, int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                    // 16-byte tile rows
  const int G = 3 * H;
  float* ws = smem;                         // [H][hb][4]
  float* tile = smem + 4 * H * hb;          // [B][ld]
  const int j0 = blockIdx.x * hb;
  load_gate_columns(ws, w, H, hb, j0);
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
    float acc[kMaxPairs][3];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) acc[n][0] = acc[n][1] = acc[n][2] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      stage_tile(tile, ld, hin, H, B, k0, kw);
      __syncthreads();
      gate_products(acc, tile, ld, ws, pb, pu, np, k0, kw, hb, wtype);
    }
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], j = j0 + pu[n];
      const T* x = xp + ((size_t)t * B + b) * G + j;
      const float r = sigmoidf(load_f(x) + acc[n][0]);
      const float z = sigmoidf(load_f(x + H) + acc[n][1]);
      const float nn = tanhf(load_f(x + 2 * H) + r * acc[n][2]);
      const float h = (1.f - z) * nn + z * hc[n];
      if (lo[n] <= t && t < hi[n]) hc[n] = h;
      hs[((size_t)t * B + b) * H + j] = hc[n];
      hout[b * H + j] = hc[n];
    }
    grid.sync();
  }
}

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    gru_bwd_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                   const float* __restrict__ h0,
                   const int* __restrict__ bounds,
                   const float* __restrict__ hs,
                   const float* __restrict__ dhs,
                   const float* __restrict__ dh_last, T* __restrict__ dxp,
                   float* __restrict__ dw, float* __restrict__ dh0,
                   float* dpbuf, int Tn, int B, int H, int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                    // 16-byte tile rows
  const int G = 3 * H;
  const int cols = 4 * hb;
  // resident: ws [H][hb][4] (gate columns), wr [hb][3H] (rows j), dwacc
  // [H][hb][4]; then tile [B][ld] and dgo [B][hb][4] (own dhp)
  float* ws = smem;
  float* wr = ws + H * cols;
  float* dwacc = wr + hb * G;
  float* tile = dwacc + H * cols;
  float* dgo = tile + B * ld;
  const int j0 = blockIdx.x * hb;
  load_gate_columns(ws, w, H, hb, j0);
  for (int e = threadIdx.x; e < H * cols; e += blockDim.x) dwacc[e] = 0.f;
  for (int e = threadIdx.x; e < hb * G; e += blockDim.x)
    wr[e] = load_f(w + (size_t)(j0 + e / G) * G + e % G);
  int pb[kMaxPairs], pu[kMaxPairs];
  const int np = my_pairs(pb, pu, B, hb);
  float dhc[kMaxPairs], dhk[kMaxPairs], zk[kMaxPairs];
  bool live[kMaxPairs];
  int lo[kMaxPairs], hi[kMaxPairs];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    dhc[n] = n < np ? dh_last[pb[n] * H + j0 + pu[n]] : 0.f;
    dhk[n] = zk[n] = 0.f;
    live[n] = false;
    lo[n] = bounds[2 * pb[n]];
    hi[n] = bounds[2 * pb[n] + 1];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * H;
  const TW* wtype = nullptr;
  const bool whole = kt >= H;               // one tile holds all of hprev

  for (int t = Tn - 1; t >= 0; --t) {
    const float* hprev = t > 0 ? hs + (size_t)(t - 1) * plane : h0;
    // 1. the gates of this CTA's units, recomputed from hprev
    float acc[kMaxPairs][3];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) acc[n][0] = acc[n][1] = acc[n][2] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      stage_tile(tile, ld, hprev, H, B, k0, kw);
      __syncthreads();
      gate_products(acc, tile, ld, ws, pb, pu, np, k0, kw, hb, wtype);
    }
    // 2. dxp and dhp of this CTA's units: dhp into the exchange buffer
    // and dgo
    float* dpx = dpbuf + (size_t)(t & 1) * B * G;
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], u = pu[n], j = j0 + u;
      const size_t row = (size_t)t * B + b;
      const T* x = xp + row * G + j;
      const float hn = acc[n][2];
      const float r = sigmoidf(load_f(x) + acc[n][0]);
      const float z = sigmoidf(load_f(x + H) + acc[n][1]);
      const float nn = tanhf(load_f(x + 2 * H) + r * hn);
      const float hp = hprev[b * H + j];
      const float dh = dhs[row * H + j] + dhc[n];
      const float dz = dh * (hp - nn);
      const float dgn = dh * (1.f - z) * (1.f - nn * nn);
      const float dgz = dz * z * (1.f - z);
      const float dgr = dgn * hn * r * (1.f - r);
      live[n] = lo[n] <= t && t < hi[n];
      const float d0 = live[n] ? dgr : 0.f;
      const float d1 = live[n] ? dgz : 0.f;
      const float d2 = live[n] ? dgn : 0.f;
      T* dx = dxp + row * G + j;
      store_f(dx, d0);
      store_f(dx + H, d1);
      store_f(dx + 2 * H, d2);
      const float p0 = round_as(d0, wtype), p1 = round_as(d1, wtype),
                  p2 = round_as(d2 * r, wtype);
      __stcg(dpx + (size_t)b * G + j, p0);
      __stcg(dpx + (size_t)b * G + H + j, p1);
      __stcg(dpx + (size_t)b * G + 2 * H + j, p2);
      *reinterpret_cast<float4*>(dgo + (b * hb + u) * 4) =
          make_float4(p0, p1, p2, 0.f);
      dhk[n] = dh;
      zk[n] = z;
    }
    // 3. dW_hh[:, own columns] += round_w(hprev)^T @ dgo
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      if (!whole) stage_tile(tile, ld, hprev, H, B, k0, kw);
      __syncthreads();
      for (int e = threadIdx.x; e < kw * hb; e += blockDim.x) {
        const int k = e / hb, u = e % hb;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f;
        for (int b = 0; b < B; ++b) {
          const float hv = round_as(tile[b * ld + k], wtype);
          const float4 gv =
              *reinterpret_cast<const float4*>(dgo + (b * hb + u) * 4);
          a0 = fmaf(hv, gv.x, a0);
          a1 = fmaf(hv, gv.y, a1);
          a2 = fmaf(hv, gv.z, a2);
        }
        float4* p = reinterpret_cast<float4*>(dwacc + ((k0 + k) * hb + u) * 4);
        float4 v = *p;
        v.x += a0;
        v.y += a1;
        v.z += a2;
        *p = v;
      }
    }
    grid.sync();
    // 4. carry = dh z + dhp @ w_hh^T for this CTA's units (live steps)
    float back[kMaxPairs];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) back[n] = 0.f;
    for (int c0 = 0; c0 < G; c0 += kt) {
      const int cw = min(kt, G - c0);
      __syncthreads();
      stage_tile(tile, ld, dpx, G, B, c0, cw);
      __syncthreads();
      for (int cc = 0; cc < cw; cc += 4) {
#pragma unroll
        for (int n = 0; n < kMaxPairs; ++n) {
          if (n >= np) break;
          const float4 gv =
              *reinterpret_cast<const float4*>(tile + pb[n] * ld + cc);
          const float4 wv =
              *reinterpret_cast<const float4*>(wr + pu[n] * G + c0 + cc);
          back[n] = fmaf(gv.x, wv.x, back[n]);
          back[n] = fmaf(gv.y, wv.y, back[n]);
          back[n] = fmaf(gv.z, wv.z, back[n]);
          back[n] = fmaf(gv.w, wv.w, back[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n)
      dhc[n] = live[n] ? dhk[n] * zk[n] + back[n] : dhk[n];
  }

  __syncthreads();
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    if (n >= np) break;
    dh0[pb[n] * H + j0 + pu[n]] = dhc[n];
  }
  for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
    const int k = e / cols, u = (e / 4) % hb, g = e % 4;
    if (g < 3) dw[(size_t)k * G + g * H + j0 + u] = dwacc[e];
  }
}

}  // namespace

extern "C" int gru_device_limits(int* out) { return device_limits(out); }

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. Grid H/hb CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory, tiles of
// kt columns (kt % 4 == 0). Returns the launch's cudaError_t.
extern "C" int gru_fwd(int x_dtype, int w_dtype, const void* xp,
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
    return launch_coop(gru_fwd_kernel<T, TW>, H / hb, threads, (size_t)smem,
                       args, static_cast<cudaStream_t>(stream));
  });
}

extern "C" int gru_bwd(int x_dtype, int w_dtype, const void* xp,
                       const void* w, const void* h0, const void* bounds,
                       const void* hs, const void* dhs, const void* dh_last,
                       void* dxp, void* dw, void* dh0, void* dpbuf, int Tn,
                       int B, int H, int hb, int kt, int threads,
                       long long smem, void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const T* a_xp = static_cast<const T*>(xp);
    const TW* a_w = static_cast<const TW*>(w);
    const float* a_h0 = static_cast<const float*>(h0);
    const int* a_bounds = static_cast<const int*>(bounds);
    const float* a_hs = static_cast<const float*>(hs);
    const float* a_dhs = static_cast<const float*>(dhs);
    const float* a_dhl = static_cast<const float*>(dh_last);
    T* a_dxp = static_cast<T*>(dxp);
    float* a_dw = static_cast<float*>(dw);
    float* a_dh0 = static_cast<float*>(dh0);
    float* a_dpbuf = static_cast<float*>(dpbuf);
    void* args[] = {&a_xp,  &a_w,   &a_h0,  &a_bounds, &a_hs, &a_dhs,
                    &a_dhl, &a_dxp, &a_dw,  &a_dh0,    &a_dpbuf,
                    &Tn,    &B,     &H,     &hb,       &kt};
    return launch_coop(gru_bwd_kernel<T, TW>, H / hb, threads, (size_t)smem,
                       args, static_cast<cudaStream_t>(stream));
  });
}
