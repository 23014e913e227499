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
// Design: the GRU kernels' (fused_gru.cu) with one gate. CTA k owns hb
// hidden units and their columns of w_hh ([H][hb], resident in shared
// memory); a thread carries up to kMaxPairs (row, unit) pairs and their
// f32 carries in registers; h crosses CTAs through a ping-pong buffer [2,
// B, H] with one grid barrier per step. I keeps its units' rows of w_hh
// and their dW columns resident, and exchanges only dz [B, H] each step.
// Tiles move through shared memory by cp.async, read at L2 only. A shape
// whose slices do not fit is refused by the host.

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

template <typename T, typename TW>
__global__ void __launch_bounds__(kMaxThreads)
    rnn_bwd_kernel(const TW* __restrict__ w, const float* __restrict__ h0,
                   const int* __restrict__ bounds,
                   const float* __restrict__ hs,
                   const float* __restrict__ dhs,
                   const float* __restrict__ dh_last, T* __restrict__ dxp,
                   float* __restrict__ dw, float* __restrict__ dh0,
                   float* dzbuf, int Tn, int B, int H, int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                    // 16-byte tile rows
  // resident: wr [hb][H] (rows j), dwacc [H][hb]; then tile [B][ld] and
  // dzo [B][hb] (own dz)
  float* wr = smem;
  float* dwacc = wr + hb * H;
  float* tile = dwacc + H * hb;
  float* dzo = tile + B * ld;
  const int j0 = blockIdx.x * hb;
  for (int e = threadIdx.x; e < H * hb; e += blockDim.x) {
    wr[e] = load_f(w + (size_t)(j0 + e / H) * H + e % H);
    dwacc[e] = 0.f;
  }
  int pb[kMaxPairs], pu[kMaxPairs];
  const int np = my_pairs(pb, pu, B, hb);
  float dhc[kMaxPairs], dhk[kMaxPairs];
  bool live[kMaxPairs];
  int lo[kMaxPairs], hi[kMaxPairs];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    dhc[n] = n < np ? dh_last[pb[n] * H + j0 + pu[n]] : 0.f;
    dhk[n] = 0.f;
    live[n] = false;
    lo[n] = bounds[2 * pb[n]];
    hi[n] = bounds[2 * pb[n] + 1];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * H;
  const TW* wtype = nullptr;

  for (int t = Tn - 1; t >= 0; --t) {
    const float* hprev = t > 0 ? hs + (size_t)(t - 1) * plane : h0;
    float* dzx = dzbuf + (size_t)(t & 1) * plane;
    // 1. dz of this CTA's units: into dxp, the exchange buffer and dzo
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], u = pu[n], j = j0 + u;
      const size_t o = ((size_t)t * B + b) * H + j;
      const float ht = hs[o];
      const float dh = dhs[o] + dhc[n];
      live[n] = lo[n] <= t && t < hi[n];
      const float dz = live[n] ? dh * (1.f - ht * ht) : 0.f;
      store_f(dxp + o, dz);
      const float dzc = round_as(dz, wtype);
      __stcg(dzx + (size_t)b * H + j, dzc);
      dzo[b * hb + u] = dzc;
      dhk[n] = dh;
    }
    // 2. dW_hh[:, own columns] += round_w(hprev)^T @ dzo
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      stage_tile(tile, ld, hprev, H, B, k0, kw);
      __syncthreads();
      for (int e = threadIdx.x; e < kw * hb; e += blockDim.x) {
        const int k = e / hb, u = e % hb;
        float a = 0.f;
        for (int b = 0; b < B; ++b)
          a = fmaf(round_as(tile[b * ld + k], wtype), dzo[b * hb + u], a);
        dwacc[(k0 + k) * hb + u] += a;
      }
    }
    grid.sync();
    // 3. carry = dz @ w_hh^T for this CTA's units (live steps)
    float back[kMaxPairs];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) back[n] = 0.f;
    for (int c0 = 0; c0 < H; c0 += kt) {
      const int cw = min(kt, H - c0);
      __syncthreads();
      stage_tile(tile, ld, dzx, H, B, c0, cw);
      __syncthreads();
      for (int cc = 0; cc < cw; cc += 4) {
#pragma unroll
        for (int n = 0; n < kMaxPairs; ++n) {
          if (n >= np) break;
          const float4 gv =
              *reinterpret_cast<const float4*>(tile + pb[n] * ld + cc);
          const float4 wv =
              *reinterpret_cast<const float4*>(wr + pu[n] * H + c0 + cc);
          back[n] = fmaf(gv.x, wv.x, back[n]);
          back[n] = fmaf(gv.y, wv.y, back[n]);
          back[n] = fmaf(gv.z, wv.z, back[n]);
          back[n] = fmaf(gv.w, wv.w, back[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) dhc[n] = live[n] ? back[n] : dhk[n];
  }

  __syncthreads();
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    if (n >= np) break;
    dh0[pb[n] * H + j0 + pu[n]] = dhc[n];
  }
  for (int e = threadIdx.x; e < H * hb; e += blockDim.x)
    dw[(size_t)(e / hb) * H + j0 + e % hb] = dwacc[e];
}

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

// x_dtype selects dxp's type (x_proj's; the kernel reads no x_proj).
extern "C" int rnn_bwd(int x_dtype, int w_dtype, const void* w,
                       const void* h0, const void* bounds, const void* hs,
                       const void* dhs, const void* dh_last, void* dxp,
                       void* dw, void* dh0, void* dzbuf, int Tn, int B, int H,
                       int hb, int kt, int threads, long long smem,
                       void* stream) {
  return dispatch_dtypes(x_dtype, w_dtype, [&](auto* xt, auto* wt) {
    using T = std::remove_pointer_t<decltype(xt)>;
    using TW = std::remove_pointer_t<decltype(wt)>;
    const TW* a_w = static_cast<const TW*>(w);
    const float* a_h0 = static_cast<const float*>(h0);
    const int* a_bounds = static_cast<const int*>(bounds);
    const float* a_hs = static_cast<const float*>(hs);
    const float* a_dhs = static_cast<const float*>(dhs);
    const float* a_dhl = static_cast<const float*>(dh_last);
    T* a_dxp = static_cast<T*>(dxp);
    float* a_dw = static_cast<float*>(dw);
    float* a_dh0 = static_cast<float*>(dh0);
    float* a_dzbuf = static_cast<float*>(dzbuf);
    void* args[] = {&a_w,   &a_h0, &a_bounds, &a_hs, &a_dhs, &a_dhl,
                    &a_dxp, &a_dw, &a_dh0,    &a_dzbuf,
                    &Tn,    &B,    &H,        &hb,   &kt};
    return launch_coop(rnn_bwd_kernel<T, TW>, H / hb, threads, (size_t)smem,
                       args, static_cast<cudaStream_t>(stream));
  });
}
