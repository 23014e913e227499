// Plumbing shared by the time-loop kernels (fused_lstm.cu, fused_gru.cu,
// fused_rnn.cu): the cooperative launch with its co-residency check,
// operand rounding to the weight's dtype, and the serial loops themselves
// over a cell that holds each kernel's step arithmetic:
// `backward_loop_kernel` (E, G, I) and `forward_loop_kernel` (D, F, H),
// with their group barrier and per-step carry products over
// double-buffered chunks; then the gates' (E, G) and dW's operand loaders
// and dW's split product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tile_gemm.cuh"
#include "tile_io.cuh"

namespace time_loop {

using tile_io::cp_async16;
using tile_io::cp_async_commit;
using tile_io::cp_async_wait;
using tile_io::load_f;
using tile_io::store_f;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// an operand rounded to the weight's dtype, as the TPU kernel casts it
// before its f32-accumulating product
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
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

// -- the serial phase of the backward loops (E, G, I) ------------------------
//
// CTA (row group g, unit group k) owns br batch rows and hb hidden units.
// Its threads form tiles of kRowTile * kRep rows x kUT units, kRowTile *
// kUT lanes each; lane l of a tile splits the reduction over columns
// (columns l*4.., in steps of 4 * kRowTile * kUT) and, after the
// reduce-scatter, owns kRep pairs: for q < kRep, row kRowTile * (kRep *
// rb + q) + l / kUT and unit kUT * ub + l % kUT. kRep > 1 carries more
// pairs per CTA than it has threads (wide H or large B), at a launch
// bound of 512 threads (768 for one pair) so that the registers still
// hold them. The host's geometry (ops/time_loop.py LOOP_TILES) matches.

constexpr int kRowTile = 4;


__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Arrive at *count and wait until it reaches `target`: a barrier over the
// CTAs that share the counter (one row group), whose writes before it are
// visible to all of them after it (release by the fence before the
// arrival, acquire by the loads that see the target). Counters start at
// zero and only grow: at its s-th barrier (from 1) a group of n CTAs waits
// for s * n.
__device__ __forceinline__ void group_barrier(unsigned* count,
                                              unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (ld_acquire(count) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// A store that other CTAs read during the launch, kept out of L1
__device__ __forceinline__ void store_cg(float* p, float x) { __stcg(p, x); }
__device__ __forceinline__ void store_cg(__nv_bfloat16* p, float x) {
  __stcg(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16(x)));
}

// 4 consecutive values as f32, from shared memory or from global memory
// (w_hh's rows when they are not resident: read-only during the launch)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Sum v over the kN lanes of an aligned group (kN a power of 2, <= 32):
// lane l returns the total of v[l]. kN - 1 shuffles in a fixed order; each
// stage halves the values a lane keeps (a template recursion, so that v
// is indexed by constants and stays in registers).
template <int kHalf, int kN>
__device__ __forceinline__ void reduce_stage(float (&v)[kN], int lane) {
  const bool up = lane & kHalf;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kHalf);
  }
  if constexpr (kHalf > 1) reduce_stage<kHalf / 2>(v, lane);
}
template <int kN>
__device__ __forceinline__ float reduce_scatter(float (&v)[kN], int lane) {
  reduce_stage<kN / 2>(v, lane);
  return v[0];
}

// The carry products of one step for the thread's kRep pairs and kOut
// outputs each: out[q][o] = sum over c < G of src[row_q][c] *
// ws[o * wstride + unit * ldw + c], src the exchanged operand rows
// [B][ldo] (in w_hh's dtype, already rounded: exact), ws the CTA's
// weight rows (resident f32 in shared memory, or rows of w_hh or of its
// transpose in global memory), kOut blocks of them wstride apart. The
// CTA's br rows move through `stage` (two buffers of br x lds elements)
// cw columns at a time by cp.async, the next chunk in flight while the
// current one is multiplied. Each weight float4 a lane loads serves the
// 4 * kRep rows of its tile. Rows past B are clamped (their pairs are not
// stored).
template <int kUT, int kRep, int kOut, typename TW, typename TS>
__device__ __forceinline__ void carry_products(
    const TW* src, int ldo, int row0, int B, int br, int G, int cw,
    const TS* ws, int ldw, size_t wstride, TW* stage, int lds, int rb,
    int ub, int lane, float (&out)[kRep][kOut]) {
  constexpr int kN = kRowTile * kUT, kRows = kRowTile * kRep;
  constexpr int kVec = 16 / sizeof(TW);
  float acc[kRep][kOut][kN];
#pragma unroll
  for (int p = 0; p < kRep; ++p)
#pragma unroll
    for (int o = 0; o < kOut; ++o)
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[p][o][i] = 0.f;
  const int nq = (G + cw - 1) / cw;
  auto issue = [&](int q) {
    const int c0 = q * cw, nv = (min(cw, G - c0) + kVec - 1) / kVec;
    TW* dst = stage + (q & 1) * br * lds;
    for (int e = threadIdx.x; e < br * nv; e += blockDim.x) {
      const int r = e / nv, v = e % nv;
      const int b = min(row0 + r, B - 1);
      cp_async16(dst + r * lds + v * kVec,
                 src + (size_t)b * ldo + c0 + v * kVec);
    }
    cp_async_commit();
  };
  issue(0);
  for (int q = 0; q < nq; ++q) {
    if (q + 1 < nq) {
      issue(q + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int c0 = q * cw, w = min(cw, G - c0);
    const TW* buf = stage + (q & 1) * br * lds + rb * kRows * lds;
    const TS* wrow = ws + ub * kUT * ldw + c0;
    for (int c = lane * 4; c < w; c += kN * 4) {
      float4 wv[kOut][kUT];
#pragma unroll
      for (int o = 0; o < kOut; ++o)
#pragma unroll
        for (int k = 0; k < kUT; ++k)
          wv[o][k] = load4(wrow + o * wstride + k * ldw + c);
#pragma unroll
      for (int p = 0; p < kRep; ++p) {
        float4 a[kRowTile];
#pragma unroll
        for (int r = 0; r < kRowTile; ++r)
          a[r] = load4(buf + (p * kRowTile + r) * lds + c);
#pragma unroll
        for (int o = 0; o < kOut; ++o)
#pragma unroll
          for (int r = 0; r < kRowTile; ++r)
#pragma unroll
            for (int k = 0; k < kUT; ++k) {
              float s = acc[p][o][r * kUT + k];
              s = fmaf(a[r].x, wv[o][k].x, s);
              s = fmaf(a[r].y, wv[o][k].y, s);
              s = fmaf(a[r].z, wv[o][k].z, s);
              acc[p][o][r * kUT + k] = fmaf(a[r].w, wv[o][k].w, s);
            }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < kRep; ++p)
#pragma unroll
    for (int o = 0; o < kOut; ++o)
      out[p][o] = reduce_scatter<kN>(acc[p][o], lane);
}

// What the serial loop of E, G and I shares, beside its cell
template <typename TW>
struct LoopArgs {
  const TW* w;          // w_hh [H][G]
  TW* opnd;             // the exchanged operand [T*B][ldo]
  const int* bounds;    // [B][2]: row b is live at start <= t < end
  unsigned* counters;   // one group-barrier counter per row group, zeroed
  int ldo, Tn, B, H, G, hb, br, cw;
};

// The serial reverse loop of a backward time loop, one cooperative launch
// over (B / br row groups) x (H / hb unit groups) CTAs. The cell holds
// what differs between E, G and I -- its carries, the step's inputs, the
// step's arithmetic:
//   Carry init(b, j)        the carries of pair (b, j) at t = T-1
//   Step fetch(t, b, j)     the step's inputs, loaded a step ahead
//   step(in, carry, live, store, row, j, op)
//                           the step's gradients: dxp[row] and the
//                           carry's operand at op (row's operand row)
//                           when `store`; leaves in carry what `carry`
//                           needs
//   carry(carry, back, live)  the carry after the product `back`
//   finish(carry, b, j)     store dh0 (and E's dc0)
// Each step a CTA runs its pairs' cells, passes its row group's barrier,
// and multiplies its rows of the operand by its rows of w_hh, resident
// in shared memory ([hb][G + 4] f32) when kResident, else read from
// global memory.
template <class Cell, int kUT, int kRep, bool kResident>
__global__ void __launch_bounds__(kRep == 1 ? 768 : 512)
    backward_loop_kernel(const Cell cell,
                         const LoopArgs<typename Cell::TW> a) {
  using TW = typename Cell::TW;
  extern __shared__ __align__(16) float smem[];
  constexpr int kN = kRowTile * kUT, kRows = kRowTile * kRep;
  const int B = a.B, G = a.G;
  const int ldw = kResident ? G + 4 : G, lds = a.cw + 16 / (int)sizeof(TW);
  const int n_units = a.H / a.hb;
  const int grp = blockIdx.x / n_units, unit0 = (blockIdx.x % n_units) * a.hb;
  const int row0 = grp * a.br;
  TW* stage = reinterpret_cast<TW*>(smem + (kResident ? (size_t)a.hb * ldw
                                                       : 0));  // [2][br][lds]
  const std::conditional_t<kResident, float, TW>* ws;
  if constexpr (kResident) {
    for (int e = threadIdx.x; e < a.hb * G; e += blockDim.x)
      smem[(e / G) * ldw + e % G] =
          load_f(a.w + (size_t)(unit0 + e / G) * G + e % G);
    ws = smem;                                                 // [hb][ldw]
  } else {
    ws = a.w + (size_t)unit0 * G;
  }
  const int tile = threadIdx.x / kN, lane = threadIdx.x % kN;
  const int n_ub = a.hb / kUT, n_tiles = (a.br / kRows) * n_ub;
  const bool in_tile = tile < n_tiles;
  const int rb = in_tile ? tile / n_ub : 0, ub = in_tile ? tile % n_ub : 0;
  const int j = unit0 + ub * kUT + lane % kUT;
  int b[kRep], lo[kRep], hi[kRep];
  bool valid[kRep];
  typename Cell::Carry carry[kRep];
  typename Cell::Step cur[kRep];
#pragma unroll
  for (int q = 0; q < kRep; ++q) {
    b[q] = row0 + rb * kRows + q * kRowTile + lane / kUT;
    valid[q] = in_tile && b[q] < B;
    b[q] = min(b[q], B - 1);             // clamped: read, never stored
    lo[q] = a.bounds[2 * b[q]];
    hi[q] = a.bounds[2 * b[q] + 1];
    carry[q] = cell.init(b[q], j);
    cur[q] = cell.fetch(a.Tn - 1, b[q], j);
  }
  unsigned* count = a.counters + grp;
  __syncthreads();

  for (int t = a.Tn - 1, s = 1; t >= 0; --t, ++s) {
    bool live[kRep];
#pragma unroll
    for (int q = 0; q < kRep; ++q) {
      const size_t row = (size_t)t * B + b[q];
      live[q] = lo[q] <= t && t < hi[q];
      cell.step(cur[q], carry[q], live[q], valid[q], row, j,
                a.opnd + row * a.ldo);
    }
    if (t > 0) {
#pragma unroll
      for (int q = 0; q < kRep; ++q) cur[q] = cell.fetch(t - 1, b[q], j);
    }
    group_barrier(count, (unsigned)(s * n_units));
    float back[kRep][1];
    carry_products<kUT, kRep, 1>(a.opnd + (size_t)t * B * a.ldo, a.ldo, row0,
                                 B, a.br, G, a.cw, ws, ldw, 0, stage, lds, rb,
                                 ub, lane, back);
#pragma unroll
    for (int q = 0; q < kRep; ++q) cell.carry(carry[q], back[q][0], live[q]);
  }
#pragma unroll
  for (int q = 0; q < kRep; ++q)
    if (valid[q]) cell.finish(carry[q], b[q], j);
}

// Launch the serial loop of `cell` for the host's geometry: thread tiles
// of ut units x 4 * rep rows ((4, 1), (2, 1), (2, 2) or (2, 4)), w_hh's
// rows resident or not.
template <class Cell>
cudaError_t launch_loop(Cell cell, LoopArgs<typename Cell::TW> a, int ut,
                        int rep, int resident, int threads, size_t smem,
                        cudaStream_t stream) {
  void* args[] = {&cell, &a};
  const int grid = ((a.B + a.br - 1) / a.br) * (a.H / a.hb);
  auto go = [&](auto kut, auto krep) -> cudaError_t {
    constexpr int kUT = decltype(kut)::value, kRep = decltype(krep)::value;
    if (resident)
      return launch_coop(backward_loop_kernel<Cell, kUT, kRep, true>, grid,
                         threads, smem, args, stream);
    return launch_coop(backward_loop_kernel<Cell, kUT, kRep, false>, grid,
                       threads, smem, args, stream);
  };
  using std::integral_constant;
  if (ut == 4 && rep == 1)
    return go(integral_constant<int, 4>(), integral_constant<int, 1>());
  if (ut == 2 && rep == 1)
    return go(integral_constant<int, 2>(), integral_constant<int, 1>());
  if (ut == 2 && rep == 2)
    return go(integral_constant<int, 2>(), integral_constant<int, 2>());
  if (ut == 2 && rep == 4)
    return go(integral_constant<int, 2>(), integral_constant<int, 4>());
  return cudaErrorInvalidValue;
}

// -- the serial forward loop (D, F, H) ---------------------------------------
//
// The forward twin of backward_loop_kernel, over the same grid of row
// groups x unit groups and the same thread tiles. Each step multiplies
// round_w(h_{t-1}) by the kOut gate columns of w_hh for the CTA's units,
// so a pair gets kOut sums; the CTA holds those columns as rows ([kOut][hb]
// [H + 4] f32, transposed as they are loaded) where they fit, else the
// grid first writes w_hh^T ([kOut * H][H], w_hh's dtype) into scratch and
// reads its rows through L2. The launch bound falls as a thread's
// accumulators (kRep * kOut * 4 * kUT) and weight vectors (kOut * kUT
// float4) grow: one bound per tile for one gate column (H: a third of
// F's sums and weight vectors; the 4 x 4 and 2 x 1 tiles above F's bound
// and the 2 x 2 tile at it, where -Xptxas -v shows no spill; the 2 x 4
// and 1 x 8 tiles at 512 threads, 2048 and 4096 pairs a CTA, which
// B=100, H=2560 needs; the 1 x 8 tile spills 20-32 bytes with f32 w_hh,
// as F's and D's 1 x 8 tiles do), one for up to 3 (F), one for 4 (D: a
// quarter more of both; 65536 registers / bound is what a thread may
// hold). The host's FORWARD_TILES match, line for line.
template <int kUT, int kRep, int kOut>
constexpr int forward_bound() {
  if (kUT == 4 && kRep == 1) return kOut == 1 ? 768 : kOut <= 3 ? 384 : 256;
  if (kUT == 2 && kRep == 1) return kOut == 1 ? 640 : kOut <= 3 ? 512 : 384;
  if (kUT == 2 && kRep == 2) return kOut == 1 ? 384 : kOut <= 3 ? 384 : 256;
  if (kUT == 2 && kRep == 4) return kOut == 1 ? 512 : kOut <= 3 ? 256 : 256;
  if (kUT == 1 && kRep == 8) return kOut == 1 ? 512 : kOut <= 3 ? 256 : 256;
  return 0;
}

template <typename TW>
struct ForwardArgs {
  const TW* w;          // w_hh [H][kOut * H]
  TW* wt;               // w_hh^T [kOut * H][H] (L2 mode only)
  TW* opnd;             // two planes [2][B][ldo] of round_w(h)
  const int* bounds;    // [B][2]: row b is live at start <= t < end
  unsigned* counters;   // a counter per row group, then one for the grid
  int ldo, Tn, B, H, hb, br, cw;
};

// The serial forward loop of a time loop, one cooperative launch over
// (B / br row groups) x (H / hb unit groups) CTAs. The cell holds what
// differs between the forward kernels:
//   kOut                    gate columns per unit (4 for D, 3 for F,
//                           1 for H)
//   Carry init(b, j)        the carries of pair (b, j) before step 0
//   float operand(carry)    the value the next step's product takes (h)
//   Step fetch(t, b, j)     the step's inputs, loaded a step ahead
//   step(in, g, carry, live, store, row, j)
//                           the step's arithmetic from the kOut sums g;
//                           updates carry (a masked step keeps it) and
//                           stores the step's outputs at row when `store`
// Before step 0 every CTA writes round_w(h0) of its pairs into operand
// plane 1 and passes its row group's barrier; step t multiplies plane
// (t - 1) & 1, runs the cells, writes plane t & 1 and passes the barrier
// again (a CTA writes plane t & 1 only after its whole row group has
// finished step t - 1, the last that read it).
template <class Cell, int kUT, int kRep, bool kResident>
__global__ void __launch_bounds__(forward_bound<kUT, kRep, Cell::kOut>())
    forward_loop_kernel(const Cell cell,
                        const ForwardArgs<typename Cell::TW> a) {
  using TW = typename Cell::TW;
  constexpr int kOut = Cell::kOut;
  extern __shared__ __align__(16) float smem[];
  constexpr int kN = kRowTile * kUT, kRows = kRowTile * kRep;
  const int B = a.B, H = a.H, G = kOut * H;
  const int ldw = kResident ? H + 4 : H, lds = a.cw + 16 / (int)sizeof(TW);
  const int n_units = H / a.hb;
  const int grp = blockIdx.x / n_units, unit0 = (blockIdx.x % n_units) * a.hb;
  const int row0 = grp * a.br;
  TW* stage = reinterpret_cast<TW*>(
      smem + (kResident ? (size_t)kOut * a.hb * ldw : 0));  // [2][br][lds]
  const std::conditional_t<kResident, float, TW>* ws;
  size_t wstride;
  if constexpr (kResident) {
    // ws[o][u][c] = w_hh[c][o*H + unit0 + u]: neighbouring threads read
    // neighbouring units
    for (int e = threadIdx.x; e < kOut * a.hb * H; e += blockDim.x) {
      const int o = e / (a.hb * H), rem = e % (a.hb * H);
      const int c = rem / a.hb, u = rem % a.hb;
      smem[(o * a.hb + u) * ldw + c] =
          load_f(a.w + (size_t)c * G + o * H + unit0 + u);
    }
    ws = smem;
    wstride = (size_t)a.hb * ldw;
  } else {
    // the grid writes w_hh^T, a slice per CTA, then waits for all of it
    const size_t n = (size_t)G * H, per = (n + gridDim.x - 1) / gridDim.x;
    size_t e1 = per * (blockIdx.x + 1);
    if (e1 > n) e1 = n;
    for (size_t e = per * blockIdx.x + threadIdx.x; e < e1; e += blockDim.x)
      a.wt[(e % G) * H + e / G] = a.w[e];
    group_barrier(a.counters + gridDim.x / n_units, gridDim.x);
    ws = a.wt + (size_t)unit0 * H;
    wstride = (size_t)H * H;
  }
  const int tile = threadIdx.x / kN, lane = threadIdx.x % kN;
  const int n_ub = a.hb / kUT, n_tiles = (a.br / kRows) * n_ub;
  const bool in_tile = tile < n_tiles;
  const int rb = in_tile ? tile / n_ub : 0, ub = in_tile ? tile % n_ub : 0;
  const int j = unit0 + ub * kUT + lane % kUT;
  const size_t plane = (size_t)B * a.ldo;
  int b[kRep], lo[kRep], hi[kRep];
  bool valid[kRep];
  typename Cell::Carry carry[kRep];
  typename Cell::Step cur[kRep];
#pragma unroll
  for (int q = 0; q < kRep; ++q) {
    b[q] = row0 + rb * kRows + q * kRowTile + lane / kUT;
    valid[q] = in_tile && b[q] < B;
    b[q] = min(b[q], B - 1);             // clamped: read, never stored
    lo[q] = a.bounds[2 * b[q]];
    hi[q] = a.bounds[2 * b[q] + 1];
    carry[q] = cell.init(b[q], j);
    cur[q] = cell.fetch(0, b[q], j);
    if (valid[q])
      store_cg(a.opnd + plane + (size_t)b[q] * a.ldo + j,
               round_as(cell.operand(carry[q]), a.opnd));
  }
  unsigned* count = a.counters + grp;
  group_barrier(count, (unsigned)n_units);

  for (int t = 0, s = 2; t < a.Tn; ++t, ++s) {
    float g[kRep][kOut];
    carry_products<kUT, kRep, kOut>(a.opnd + ((t + 1) & 1) * plane, a.ldo,
                                    row0, B, a.br, H, a.cw, ws, ldw, wstride,
                                    stage, lds, rb, ub, lane, g);
#pragma unroll
    for (int q = 0; q < kRep; ++q) {
      const bool live = lo[q] <= t && t < hi[q];
      cell.step(cur[q], g[q], carry[q], live, valid[q],
                (size_t)t * B + b[q], j);
    }
    if (t + 1 == a.Tn) break;
#pragma unroll
    for (int q = 0; q < kRep; ++q) {
      cur[q] = cell.fetch(t + 1, b[q], j);
      if (valid[q])
        store_cg(a.opnd + (t & 1) * plane + (size_t)b[q] * a.ldo + j,
                 round_as(cell.operand(carry[q]), a.opnd));
    }
    group_barrier(count, (unsigned)(s * n_units));
  }
}

// Zero the loop's barrier counters (row groups + 1) on the stream, then
// launch the forward loop of `cell` for the host's geometry: thread tiles
// of ut units x 4 * rep rows ((4, 1), (2, 1), (2, 2), (2, 4) or (1, 8)),
// the gate columns resident or read from w_hh^T in a.wt. Returns the
// first error.
template <class Cell>
cudaError_t launch_forward(Cell cell, ForwardArgs<typename Cell::TW> a,
                           int ut, int rep, int resident, int threads,
                           size_t smem, cudaStream_t stream) {
  const int groups = (a.B + a.br - 1) / a.br;
  cudaError_t err = cudaMemsetAsync(a.counters, 0,
                                    (groups + 1) * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  void* args[] = {&cell, &a};
  const int grid = groups * (a.H / a.hb);
  auto go = [&](auto kut, auto krep) -> cudaError_t {
    constexpr int kUT = decltype(kut)::value, kRep = decltype(krep)::value;
    if (resident)
      return launch_coop(forward_loop_kernel<Cell, kUT, kRep, true>, grid,
                         threads, smem, args, stream);
    return launch_coop(forward_loop_kernel<Cell, kUT, kRep, false>, grid,
                       threads, smem, args, stream);
  };
  using std::integral_constant;
  if (ut == 4 && rep == 1)
    return go(integral_constant<int, 4>(), integral_constant<int, 1>());
  if (ut == 2 && rep == 1)
    return go(integral_constant<int, 2>(), integral_constant<int, 1>());
  if (ut == 2 && rep == 2)
    return go(integral_constant<int, 2>(), integral_constant<int, 2>());
  if (ut == 2 && rep == 4)
    return go(integral_constant<int, 2>(), integral_constant<int, 4>());
  if (ut == 1 && rep == 8)
    return go(integral_constant<int, 1>(), integral_constant<int, 8>());
  return cudaErrorInvalidValue;
}

// -- the parallel phases of the backward loops (E, G; I's dW) ---------------

// A(k, i) of a product over hprev = [h0; hs[:-1]] ([T*B, H], row m = t*B
// + b), rounded to w_hh's dtype as the TPU kernel feeds it to the MXU.
// kByRow: i is the row m and k the column (round_w(hprev) @ w_hh, phase
// 1); otherwise k is the row and i the column (round_w(hprev)^T @ ...,
// phase 3).
template <typename TH, typename TW, bool kByRow>
struct Hprev {
  static constexpr bool kContigK = kByRow;
  const TH* hs;
  const float* h0;
  int M, B, H;
  __device__ __forceinline__ float operator()(int k, int i) const {
    const int m = kByRow ? i : k, c = kByRow ? k : i;
    if (m >= M || c >= H) return 0.f;
    const float v = m < B ? h0[(size_t)m * H + c]
                          : load_f(hs + (size_t)(m - B) * H + c);
    return round_as(v, static_cast<const TW*>(nullptr));
  }
};

// B(k, n) = w_hh[k][g*H + u] for n = 4u + g and g < kGates, else 0: the
// gate columns permuted so that a unit's gates are 4 neighbouring
// columns of the product, and one thread's 4 columns give all of them
template <typename TW, int kGates>
struct GateCols {
  static constexpr bool kContigK = false;
  const TW* w;
  int H;
  __device__ __forceinline__ float operator()(int k, int n) const {
    const int u = n >> 2, g = n & 3;
    if (k >= H || u >= H || g >= kGates) return 0.f;
    return load_f(w + (size_t)k * kGates * H + g * H + u);
  }
};

// B(m, n) = the exchanged operand [M][ldo] of phase 2, n < G
template <typename TW>
struct Operand {
  static constexpr bool kContigK = false;
  const TW* p;
  int ldo, M, G;
  __device__ __forceinline__ float operator()(int m, int n) const {
    return m < M && n < G ? load_f(p + (size_t)m * ldo + n) : 0.f;
  }
};

// Phase 3: part[s] = round_w(hprev)^T @ operand over rows [s*kchunk,
// (s+1)*kchunk) of the T*B, one 128 x 128 tile of [H, G] per CTA
template <typename TH, typename TW>
__global__ void __launch_bounds__(tile_gemm::kThreads)
    dw_kernel(const TH* __restrict__ hs, const float* __restrict__ h0,
              const TW* __restrict__ opnd, int ldo, float* __restrict__ part,
              int M, int B, int H, int G, int kchunk) {
  __shared__ __align__(16) tile_gemm::Smem sm;
  const int n0 = blockIdx.x * tile_gemm::kBN, i0 = blockIdx.y * tile_gemm::kBM;
  const int kbeg = blockIdx.z * kchunk, kend = min(M, kbeg + kchunk);
  const Hprev<TH, TW, false> la{hs, h0, M, B, H};
  const Operand<TW> lb{opnd, ldo, M, G};
  float acc[8][8];
  tile_gemm::product(acc, sm, la, lb, i0, n0, kbeg, kend);
  float* out = part + (size_t)blockIdx.z * H * G;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int i = i0 + tile_gemm::out_index(ty, ii);
    if (i >= H) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + tile_gemm::out_index(tx, 4 * h);
      if (n >= G) continue;  // G % 4 == 0: the 4 columns are all in
      *reinterpret_cast<float4*>(out + (size_t)i * G + n) =
          make_float4(acc[ii][4 * h], acc[ii][4 * h + 1], acc[ii][4 * h + 2],
                      acc[ii][4 * h + 3]);
    }
  }
}

// Launch phase 3 into dw [H, G] f32: `splits` CTAs per output tile over
// the T*B rows, their partials (in part, [splits, H, G], unused when
// splits == 1) summed in a fixed order. *launched counts the kernels
// launched (1, or 2 with the sum of the parts).
template <typename TH, typename TW>
cudaError_t launch_dw(const void* hs, const void* h0, const void* opnd,
                      int ldo, void* part, void* dw, int M, int B, int H,
                      int G, int splits, int kchunk, int* launched,
                      cudaStream_t stream) {
  *launched = 0;
  const dim3 grid((G + tile_gemm::kBN - 1) / tile_gemm::kBN,
                  (H + tile_gemm::kBM - 1) / tile_gemm::kBM, splits);
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  dw_kernel<TH, TW><<<grid, tile_gemm::kThreads, 0, stream>>>(
      static_cast<const TH*>(hs), static_cast<const float*>(h0),
      static_cast<const TW*>(opnd), ldo, out, M, B, H, G, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;
  if (splits == 1) return err;
  const long long n = (long long)H * G;
  const long long want = (n / 4 + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  tile_gemm::reduce_splits<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), n, splits);
  if ((err = cudaGetLastError()) == cudaSuccess) *launched = 2;
  return err;
}

// Call f(T*, TW*) with null pointers whose types select x_proj's and
// w_hh's element types from the host's codes (0 = float32, 1 = bfloat16);
// returns f's cudaError_t as an int.
template <typename F>
int dispatch_dtypes(int x_dtype, int w_dtype, F&& f) {
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return (int)f(static_cast<float*>(nullptr), static_cast<float*>(nullptr));
  if (x_dtype == 0 && w_dtype == 1)
    return (int)f(static_cast<float*>(nullptr), static_cast<bf16*>(nullptr));
  if (x_dtype == 1 && w_dtype == 0)
    return (int)f(static_cast<bf16*>(nullptr), static_cast<float*>(nullptr));
  if (x_dtype == 1 && w_dtype == 1)
    return (int)f(static_cast<bf16*>(nullptr), static_cast<bf16*>(nullptr));
  return (int)cudaErrorInvalidValue;
}

// The card's limits the host's geometry needs: out[0] = SM count, out[1] =
// shared memory a block may opt in to (bytes), out[2] = 1 if cooperative
// launches are supported.
inline int device_limits(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaDeviceGetAttribute(&out[2], cudaDevAttrCooperativeLaunch, dev);
  return (int)cudaGetLastError();
}

}  // namespace time_loop
