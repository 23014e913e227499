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
// and moves ~82 MB (0.025 ms); E does three such products per step.
//
// Design. The time loop runs inside one cooperative launch, as the TPU
// kernel runs it inside one pallas_call. CTA k owns hb hidden units j in
// [k*hb, (k+1)*hb), and with them the gate columns j, H+j, 2H+j, 3H+j of
// w_hh, staged once into shared memory (interleaved [H][hb][4], so one
// 16-byte load gives a unit's four gates) when the slice fits; otherwise
// (H=1280) each step reads it from global memory through L1/L2. A thread
// owns up to kMaxPairs (row b, unit j) pairs, and the c carry (and in E
// the dh, dc carries) of each pair in registers: the cell update is
// elementwise in j, so c never leaves the CTA. Only h crosses CTAs: every
// CTA needs all of h_{t-1} [B, H] for its product, so each step writes
// its units of h (f32, not hs, which may be bf16) into a ping-pong buffer
// [2, B, H] and ends with one grid-wide barrier (cooperative_groups
// this_grid().sync()). E does the same with dgates through a [2, B, 4H]
// buffer; its dh_back for its units reads the rows j of w_hh, a second
// resident slice, and it accumulates its columns of dW_hh in shared
// memory (no atomics: each column has one owner), written once at the
// end. Tiles of h (and of dgates) move through shared memory kt columns
// at a time, kt as wide as shared memory allows beside the resident
// slices (the host picks it: all of h at once in D at H=512), copied with
// cp.async so that a tile costs one trip to L2, not one per load. Buffers
// written during the launch are read at L2 only (cp.async.cg,
// ld.global.cg): L1 is not coherent across SMs. The host checks that the
// grid is co-resident before launching. Later work: tensor-core
// products, double-buffered tiles, a cheaper dgates exchange for E.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_io.cuh"

namespace cg = cooperative_groups;

namespace {

using tile_io::load_f;
using tile_io::store_f;

constexpr int kMaxPairs = 4;  // (row, unit) pairs one thread carries
constexpr int kMaxThreads = 512;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// an operand rounded to the weight's dtype, as the TPU kernel casts it
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// 4 consecutive values of a row of src (f32 or bf16) as f32; cg loads
// (L2 only) for buffers other CTAs write during the launch
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldcg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldcg(reinterpret_cast<const uint2*>(p));
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Stage columns [k0, k0+kw) of src [B, ld_src] (kw % 4 == 0) into tile
// [B][ld] as f32; the caller synchronises the block after it. An f32
// source moves by cp.async (16 bytes a copy, L2 only, every copy of the
// thread in flight at once); a bf16 source through registers, 8 loads in
// flight per thread.
__device__ __forceinline__ void stage_tile(float* tile, int ld,
                                           const float* src, int ld_src,
                                           int B, int k0, int kw) {
  const int q = kw / 4;
  for (int e = threadIdx.x; e < B * q; e += blockDim.x) {
    const int b = e / q, c = (e % q) * 4;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(tile + b * ld + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src + (size_t)b * ld_src + k0 + c));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void stage_tile(float* tile, int ld,
                                           const __nv_bfloat16* src,
                                           int ld_src, int B, int k0,
                                           int kw) {
  constexpr int kBatch = 8;
  const int q = kw / 4, n = B * q;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * blockDim.x) {
    float4 v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < n) v[i] = load4(src + (size_t)(e / q) * ld_src + k0 + (e % q) * 4);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < n)
        *reinterpret_cast<float4*>(tile + (e / q) * ld + (e % q) * 4) = v[i];
    }
  }
}

// The four gate weights (i, f, g, o) of unit u at row k of w_hh: from the
// resident slice [H][hb][4], or from global memory.
template <bool kSmem, typename TW>
__device__ __forceinline__ float4 w_cols(const float* ws, const TW* w, int k,
                                         int u, int hb, int H, int j0) {
  if (kSmem) return *reinterpret_cast<const float4*>(ws + (k * hb + u) * 4);
  const TW* r = w + (size_t)k * 4 * H + j0 + u;
  return make_float4(load_f(r), load_f(r + H), load_f(r + 2 * H),
                     load_f(r + 3 * H));
}

// acc[n][g] += sum_k round_w(tile[b_n][k]) * w[k0+k][gate g of unit u_n],
// over a staged tile of kw columns
template <bool kSmem, typename TW>
__device__ __forceinline__ void gate_products(
    float (&acc)[kMaxPairs][4], const float* tile, int ld, const float* ws,
    const TW* w, const int (&pb)[kMaxPairs], const int (&pu)[kMaxPairs],
    int np, int k0, int kw, int hb, int H, int j0) {
  for (int kk = 0; kk < kw; kk += 4) {
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const float4 hv =
          *reinterpret_cast<const float4*>(tile + pb[n] * ld + kk);
      const float hvs[4] = {round_as(hv.x, w), round_as(hv.y, w),
                            round_as(hv.z, w), round_as(hv.w, w)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = w_cols<kSmem>(ws, w, k0 + kk + q, pu[n], hb, H, j0);
        acc[n][0] = fmaf(hvs[q], wv.x, acc[n][0]);
        acc[n][1] = fmaf(hvs[q], wv.y, acc[n][1]);
        acc[n][2] = fmaf(hvs[q], wv.z, acc[n][2]);
        acc[n][3] = fmaf(hvs[q], wv.w, acc[n][3]);
      }
    }
  }
}

// this thread's (row, unit) pairs: pair p = tid + n * blockDim
__device__ __forceinline__ int my_pairs(int (&pb)[kMaxPairs],
                                        int (&pu)[kMaxPairs], int B, int hb) {
  int np = 0;
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    const int p = threadIdx.x + n * blockDim.x;
    pb[n] = 0;
    pu[n] = 0;
    if (p < B * hb) {
      pb[n] = p / hb;
      pu[n] = p % hb;
      np = n + 1;
    }
  }
  return np;
}

template <typename T, typename TW, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_fwd_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ bounds, T* __restrict__ hs,
                    float* __restrict__ cs, float* hbuf, int Tn, int B, int H,
                    int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                             // 16-byte tile rows
  float* ws = smem;                                  // [H][hb][4]
  float* tile = smem + (kSmem ? 4 * H * hb : 0);     // [B][ld]
  const int j0 = blockIdx.x * hb;
  if (kSmem) {
    for (int e = threadIdx.x; e < 4 * H * hb; e += blockDim.x) {
      const int k = e / (4 * hb), u = (e / 4) % hb, g = e % 4;
      ws[e] = load_f(w + (size_t)k * 4 * H + g * H + j0 + u);
    }
  }
  int pb[kMaxPairs], pu[kMaxPairs];
  const int np = my_pairs(pb, pu, B, hb);
  float hc[kMaxPairs], cc[kMaxPairs];
  int lo[kMaxPairs], hi[kMaxPairs];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    const int o = pb[n] * H + j0 + pu[n];
    hc[n] = n < np ? h0[o] : 0.f;
    cc[n] = n < np ? c0[o] : 0.f;
    lo[n] = bounds[2 * pb[n]];
    hi[n] = bounds[2 * pb[n] + 1];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * H;

  for (int t = 0; t < Tn; ++t) {
    const float* hin = t == 0 ? h0 : hbuf + ((t - 1) & 1) * plane;
    float* hout = hbuf + (t & 1) * plane;
    float acc[kMaxPairs][4];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      stage_tile(tile, ld, hin, H, B, k0, kw);
      __syncthreads();
      gate_products<kSmem>(acc, tile, ld, ws, w, pb, pu, np, k0, kw, hb, H,
                           j0);
    }
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], j = j0 + pu[n];
      const T* x = xp + ((size_t)t * B + b) * 4 * H + j;
      const float gi = sigmoidf(load_f(x) + acc[n][0]);
      const float gf = sigmoidf(load_f(x + H) + acc[n][1]);
      const float gg = tanhf(load_f(x + 2 * H) + acc[n][2]);
      const float go = sigmoidf(load_f(x + 3 * H) + acc[n][3]);
      const float c = gf * cc[n] + gi * gg;
      const float h = go * tanhf(c);
      if (lo[n] <= t && t < hi[n]) {
        cc[n] = c;
        hc[n] = h;
      }
      const size_t o = ((size_t)t * B + b) * H + j;
      store_f(hs + o, hc[n]);
      cs[o] = cc[n];
      hout[b * H + j] = hc[n];
    }
    grid.sync();
  }
}

template <typename T, typename TW, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_bwd_kernel(const T* __restrict__ xp, const TW* __restrict__ w,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    const int* __restrict__ bounds, const T* __restrict__ hs,
                    const float* __restrict__ cs, const T* __restrict__ dhs,
                    const float* __restrict__ dh_last,
                    const float* __restrict__ dc_last, T* __restrict__ dxp,
                    float* __restrict__ dw, float* __restrict__ dh0,
                    float* __restrict__ dc0, float* dgbuf, int Tn, int B,
                    int H, int hb, int kt) {
  extern __shared__ __align__(16) float smem[];
  const int ld = kt + 4;                             // 16-byte tile rows
  const int G = 4 * H;
  const int cols = 4 * hb;
  // resident: ws [H][hb][4] (columns), wr [hb][4H] (rows j), dwacc
  // [H][hb][4]; always: tile [B][ld], dgo [B][hb][4] (own dgates)
  float* ws = smem;
  float* wr = ws + (kSmem ? H * cols : 0);
  float* dwacc = wr + (kSmem ? H * cols : 0);
  float* tile = dwacc + (kSmem ? H * cols : 0);
  float* dgo = tile + B * ld;
  const int j0 = blockIdx.x * hb;
  if (kSmem) {
    for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
      const int k = e / cols, u = (e / 4) % hb, g = e % 4;
      ws[e] = load_f(w + (size_t)k * G + g * H + j0 + u);
      dwacc[e] = 0.f;
    }
    for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
      const int u = e / G, c = e % G;
      wr[e] = load_f(w + (size_t)(j0 + u) * G + c);
    }
  } else {
    for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
      const int k = e / cols, u = (e / 4) % hb, g = e % 4;
      dw[(size_t)k * G + g * H + j0 + u] = 0.f;
    }
  }
  int pb[kMaxPairs], pu[kMaxPairs];
  const int np = my_pairs(pb, pu, B, hb);
  float dhc[kMaxPairs], dcc[kMaxPairs], dhk[kMaxPairs];
  bool live[kMaxPairs];
  int lo[kMaxPairs], hi[kMaxPairs];
#pragma unroll
  for (int n = 0; n < kMaxPairs; ++n) {
    const int o = pb[n] * H + j0 + pu[n];
    dhc[n] = n < np ? dh_last[o] : 0.f;
    dcc[n] = n < np ? dc_last[o] : 0.f;
    dhk[n] = 0.f;
    live[n] = false;
    lo[n] = bounds[2 * pb[n]];
    hi[n] = bounds[2 * pb[n] + 1];
  }
  cg::grid_group grid = cg::this_grid();
  const size_t plane = (size_t)B * H;
  const TW* wtype = nullptr;

  for (int t = Tn - 1; t >= 0; --t) {
    // 1. the gates of this CTA's units, recomputed from hprev
    float acc[kMaxPairs][4];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      if (t > 0)
        stage_tile(tile, ld, hs + (t - 1) * plane, H, B, k0, kw);
      else
        stage_tile(tile, ld, h0, H, B, k0, kw);
      __syncthreads();
      gate_products<kSmem>(acc, tile, ld, ws, w, pb, pu, np, k0, kw, hb, H,
                           j0);
    }
    // 2. dgates of this CTA's units: into dxp, the exchange buffer and dgo
    float* dgx = dgbuf + (size_t)(t & 1) * B * G;
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) {
      if (n >= np) break;
      const int b = pb[n], u = pu[n], j = j0 + u;
      const size_t row = (size_t)t * B + b;
      const T* x = xp + row * G + j;
      const float gi = sigmoidf(load_f(x) + acc[n][0]);
      const float gf = sigmoidf(load_f(x + H) + acc[n][1]);
      const float gg = tanhf(load_f(x + 2 * H) + acc[n][2]);
      const float go = sigmoidf(load_f(x + 3 * H) + acc[n][3]);
      const float ct = cs[row * H + j];
      const float cprev = t > 0 ? cs[(row - B) * H + j] : c0[b * H + j];
      const float tc = tanhf(ct);
      const float dh = load_f(dhs + row * H + j) + dhc[n];
      const float d_o = dh * tc * go * (1.f - go);
      const float dc = dcc[n] + dh * go * (1.f - tc * tc);
      const float d_i = dc * gg * gi * (1.f - gi);
      const float d_f = dc * cprev * gf * (1.f - gf);
      const float d_g = dc * gi * (1.f - gg * gg);
      live[n] = lo[n] <= t && t < hi[n];
      float d[4] = {d_i, d_f, d_g, d_o};
      T* dx = dxp + row * G + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        if (!live[n]) d[g] = 0.f;
        store_f(dx + g * H, d[g]);
        d[g] = round_as(d[g], wtype);
        __stcg(dgx + (size_t)b * G + g * H + j, d[g]);
      }
      *reinterpret_cast<float4*>(dgo + (b * hb + u) * 4) =
          make_float4(d[0], d[1], d[2], d[3]);
      dhk[n] = dh;
      if (live[n]) dcc[n] = dc * gf;
    }
    // 3. dW_hh[:, own columns] += round_w(hprev)^T @ dgo
    for (int k0 = 0; k0 < H; k0 += kt) {
      const int kw = min(kt, H - k0);
      __syncthreads();
      if (t > 0)
        stage_tile(tile, ld, hs + (t - 1) * plane, H, B, k0, kw);
      else
        stage_tile(tile, ld, h0, H, B, k0, kw);
      __syncthreads();
      for (int e = threadIdx.x; e < kw * hb; e += blockDim.x) {
        const int k = e / hb, u = e % hb;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int b = 0; b < B; ++b) {
          const float hv = round_as(tile[b * ld + k], wtype);
          const float4 gv =
              *reinterpret_cast<const float4*>(dgo + (b * hb + u) * 4);
          a0 = fmaf(hv, gv.x, a0);
          a1 = fmaf(hv, gv.y, a1);
          a2 = fmaf(hv, gv.z, a2);
          a3 = fmaf(hv, gv.w, a3);
        }
        const int kg = k0 + k;
        if (kSmem) {
          float4* p = reinterpret_cast<float4*>(dwacc + (kg * hb + u) * 4);
          float4 v = *p;
          v.x += a0;
          v.y += a1;
          v.z += a2;
          v.w += a3;
          *p = v;
        } else {
          float* p = dw + (size_t)kg * G + j0 + u;
          p[0] += a0;
          p[H] += a1;
          p[2 * H] += a2;
          p[3 * H] += a3;
        }
      }
    }
    grid.sync();
    // 4. dh_back = round_w(dgates) @ w_hh^T for this CTA's units
    float back[kMaxPairs];
#pragma unroll
    for (int n = 0; n < kMaxPairs; ++n) back[n] = 0.f;
    for (int c0_ = 0; c0_ < G; c0_ += kt) {
      const int cw = min(kt, G - c0_);
      __syncthreads();
      stage_tile(tile, ld, dgx, G, B, c0_, cw);
      __syncthreads();
      for (int cc4 = 0; cc4 < cw; cc4 += 4) {
#pragma unroll
        for (int n = 0; n < kMaxPairs; ++n) {
          if (n >= np) break;
          const float4 gv =
              *reinterpret_cast<const float4*>(tile + pb[n] * ld + cc4);
          float4 wv;
          if (kSmem) {
            wv = *reinterpret_cast<const float4*>(wr + pu[n] * G + c0_ + cc4);
          } else {
            const TW* r = w + (size_t)(j0 + pu[n]) * G + c0_ + cc4;
            wv = make_float4(load_f(r), load_f(r + 1), load_f(r + 2),
                             load_f(r + 3));
          }
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
    const int o = pb[n] * H + j0 + pu[n];
    dh0[o] = dhc[n];
    dc0[o] = dcc[n];
  }
  if (kSmem) {
    for (int e = threadIdx.x; e < H * cols; e += blockDim.x) {
      const int k = e / cols, u = (e / 4) % hb, g = e % 4;
      dw[(size_t)k * G + g * H + j0 + u] = dwacc[e];
    }
  }
}

// Launch kern over `grid` CTAs as one cooperative launch, after checking
// that the grid can be co-resident (a grid barrier over CTAs that cannot
// all run at once never returns).
template <typename K>
cudaError_t launch_coop(K kern, int grid, int threads, size_t smem,
                        void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t fwd(int w_smem, const void* xp, const void* w, const void* h0,
                const void* c0, const void* bounds, void* hs, void* cs,
                void* hbuf, int Tn, int B, int H, int hb, int kt,
                int threads, size_t smem, cudaStream_t stream) {
  const T* a_xp = static_cast<const T*>(xp);
  const TW* a_w = static_cast<const TW*>(w);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  const int* a_bounds = static_cast<const int*>(bounds);
  T* a_hs = static_cast<T*>(hs);
  float* a_cs = static_cast<float*>(cs);
  float* a_hbuf = static_cast<float*>(hbuf);
  void* args[] = {&a_xp, &a_w, &a_h0, &a_c0, &a_bounds, &a_hs,
                  &a_cs, &a_hbuf, &Tn, &B, &H, &hb, &kt};
  if (w_smem)
    return launch_coop(lstm_fwd_kernel<T, TW, true>, H / hb, threads, smem,
                       args, stream);
  return launch_coop(lstm_fwd_kernel<T, TW, false>, H / hb, threads, smem,
                     args, stream);
}

template <typename T, typename TW>
cudaError_t bwd(int w_smem, const void* xp, const void* w, const void* h0,
                const void* c0, const void* bounds, const void* hs,
                const void* cs, const void* dhs, const void* dh_last,
                const void* dc_last, void* dxp, void* dw, void* dh0,
                void* dc0, void* dgbuf, int Tn, int B, int H, int hb,
                int kt, int threads, size_t smem, cudaStream_t stream) {
  const T* a_xp = static_cast<const T*>(xp);
  const TW* a_w = static_cast<const TW*>(w);
  const float* a_h0 = static_cast<const float*>(h0);
  const float* a_c0 = static_cast<const float*>(c0);
  const int* a_bounds = static_cast<const int*>(bounds);
  const T* a_hs = static_cast<const T*>(hs);
  const float* a_cs = static_cast<const float*>(cs);
  const T* a_dhs = static_cast<const T*>(dhs);
  const float* a_dhl = static_cast<const float*>(dh_last);
  const float* a_dcl = static_cast<const float*>(dc_last);
  T* a_dxp = static_cast<T*>(dxp);
  float* a_dw = static_cast<float*>(dw);
  float* a_dh0 = static_cast<float*>(dh0);
  float* a_dc0 = static_cast<float*>(dc0);
  float* a_dgbuf = static_cast<float*>(dgbuf);
  void* args[] = {&a_xp,  &a_w,   &a_h0,  &a_c0,  &a_bounds, &a_hs,
                  &a_cs,  &a_dhs, &a_dhl, &a_dcl, &a_dxp,    &a_dw,
                  &a_dh0, &a_dc0, &a_dgbuf, &Tn,  &B,        &H,
                  &hb,    &kt};
  if (w_smem)
    return launch_coop(lstm_bwd_kernel<T, TW, true>, H / hb, threads, smem,
                       args, stream);
  return launch_coop(lstm_bwd_kernel<T, TW, false>, H / hb, threads, smem,
                     args, stream);
}

}  // namespace

// The card's limits the host's geometry needs: out[0] = SM count, out[1] =
// shared memory a block may opt in to (bytes), out[2] = 1 if cooperative
// launches are supported.
extern "C" int lstm_device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  return (int)cudaGetLastError();
}

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16. Grid H/hb CTAs of
// `threads` threads and `smem` bytes of dynamic shared memory, tiles of
// kt columns (kt % 4 == 0); w_smem = 1 keeps the w_hh slice resident.
// Returns the launch's cudaError_t.
extern "C" int lstm_fwd(int x_dtype, int w_dtype, int w_smem, const void* xp,
                        const void* w, const void* h0, const void* c0,
                        const void* bounds, void* hs, void* cs, void* hbuf,
                        int Tn, int B, int H, int hb, int kt, int threads,
                        long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)fwd<float, float>(w_smem, xp, w, h0, c0, bounds, hs, cs, hbuf,
                                  Tn, B, H, hb, kt, threads, sm, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)fwd<float, __nv_bfloat16>(w_smem, xp, w, h0, c0, bounds, hs,
                                          cs, hbuf, Tn, B, H, hb, kt, threads, sm,
                                          s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)fwd<__nv_bfloat16, float>(w_smem, xp, w, h0, c0, bounds, hs,
                                          cs, hbuf, Tn, B, H, hb, kt, threads, sm,
                                          s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)fwd<__nv_bfloat16, __nv_bfloat16>(w_smem, xp, w, h0, c0,
                                                  bounds, hs, cs, hbuf, Tn, B,
                                                  H, hb, kt, threads, sm, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_bwd(int x_dtype, int w_dtype, int w_smem, const void* xp,
                        const void* w, const void* h0, const void* c0,
                        const void* bounds, const void* hs, const void* cs,
                        const void* dhs, const void* dh_last,
                        const void* dc_last, void* dxp, void* dw, void* dh0,
                        void* dc0, void* dgbuf, int Tn, int B, int H, int hb,
                        int kt, int threads, long long smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)bwd<float, float>(w_smem, xp, w, h0, c0, bounds, hs, cs, dhs,
                                  dh_last, dc_last, dxp, dw, dh0, dc0, dgbuf,
                                  Tn, B, H, hb, kt, threads, sm, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)bwd<float, __nv_bfloat16>(w_smem, xp, w, h0, c0, bounds, hs,
                                          cs, dhs, dh_last, dc_last, dxp, dw,
                                          dh0, dc0, dgbuf, Tn, B, H, hb,
                                          kt, threads, sm, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)bwd<__nv_bfloat16, float>(w_smem, xp, w, h0, c0, bounds, hs,
                                          cs, dhs, dh_last, dc_last, dxp, dw,
                                          dh0, dc0, dgbuf, Tn, B, H, hb,
                                          kt, threads, sm, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)bwd<__nv_bfloat16, __nv_bfloat16>(
        w_smem, xp, w, h0, c0, bounds, hs, cs, dhs, dh_last, dc_last, dxp, dw,
        dh0, dc0, dgbuf, Tn, B, H, hb, kt, threads, sm, s);
  return (int)cudaErrorInvalidValue;
}
