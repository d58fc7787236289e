// Input gradient (dx) of the stride-2 3x3x3 pad-1 convolution on NDHWC bf16,
// on the tensor cores, for Hopper (sm_90a). Plain C interface, bound with
// ctypes (ops/conv3d.py conv3d_k3_dx at stride 2).
//
// Replaces the TPU's Pallas kernel
//   mt3d_resenc_unet_tpu/ops/pallas_conv.py::_s2_dx_kernel (via
//     _conv3d_s2_dx_impl: the backward of conv3d_s2_packed, the encoder's
//     downsampling convs 32->64 and 64->128)
// For the forward y[o] = sum_k x[2o - 1 + k] . w[k] it computes
//   dx[i, ci] = sum_{k, co} g[(i + 1 - k) / 2, co] * w[k, ci, co]
// over the taps k for which (i + 1 - k) / 2 is a whole number, g zero
// outside the volume, and the fusions of conv3d_k3_dx_s1.cu: CORR (g =
// bf16(gy + gs[0] + 2*y*gs[1]) once per staged element, 0 outside the
// volume) and POST (du = acc * leaky'(x*scale - shift), bf16(du*scale) and
// [sum du*x; sum du] per (sample, channel) into dst, in a fixed order).
//
// What bounds it on the H100: the bytes. A dx value takes 2*27/8*Co FLOPs
// on average, and dx, written once, has 8 times gy's voxels: at 32 -> 64
// from 128^3, N=2, 58 GFLOP against 0.40 GB with CORR (0.059 ms of bf16
// peak, 0.12 ms of HBM).
//
// Design: an implicit GEMM per parity class on mma.sync.m16n8k16 (bf16 in,
// fp32 accumulate), fed by a 2-stage cp.async ring over chunks of 16
// cotangent channels.
//   Parity classes. Along an axis a dx voxel i = 2q + p takes tap k = 1
//     from g[q] when p = 0, and taps k = 0 from g[q + 1] and k = 2 from
//     g[q] when p = 1 (the TPU kernel's _S2_DX_TAPS). So the dx voxels of a
//     class (p_d, p_h, p_w) take 1, 2, 4 or 8 taps, 27 over the 8 classes,
//     and tap by tap their A rows are the cotangent at q shifted by 0 or +1
//     per axis: a stride-1-like GEMM over the same staged rows.
//   Units. A unit is a brick of 2 x 8 x 8 cotangent positions q of one
//     sample (the 1,024 dx voxels 2q + p of all 8 classes) and 32 dx
//     channels. Per chunk the block stages the brick's footprint, the
//     positions q .. q + 1 (3 x 9 x 9 rows of 16 channels, zero-filled past
//     the volume's far end: the odd classes' g[q + 1] at the last q is 0),
//     and all 27 taps' weights for the unit's 32 ci; with CORR the y
//     footprint beside it, and the gy footprint is rewritten in place into
//     g. So every staged element feeds all the
//     taps of all 8 classes, and gy is read from device memory once. The
//     footprint is row-major (ops/conv3d.py dx_s2_row), so a tap's 8
//     consecutive dx voxels along w (consecutive q) are 8 consecutive rows,
//     and the rows and weights take conv3d_k3_dx_s1.cu's 32-byte swizzle.
//   Warps. Each class has 128 dx voxels here, eight 16-row MMA tiles (two
//     lines of 8 along w). Warp w of 16 owns tile w / 2 of four classes:
//     {0, 1, 2, 7} for even w (1 + 2 + 2 + 8 = 13 taps), {3, 4, 5, 6} for
//     odd w (4 + 2 + 4 + 4 = 14), so the warps' MMAs per chunk differ by 1
//     tap in 14; 4 classes x 4 x 8-column tiles = 64 fp32 sums a thread.
//     The two class sets are compile-time lists (class_products), so every
//     tap's weight row and footprint shift is a constant; on an H100 that
//     ran 12-15% faster than a loop over runtime tap lists, 16 warps over
//     this brick 3-6% faster again than 8 over a 2 x 4 x 8 brick at two
//     blocks per SM (half the weight bytes staged per dx voxel), and y
//     staged in the ring beside gy 5-11% faster again than in a single
//     buffer loaded after the rewrite (one barrier less a chunk).
//   Persistent blocks walk contiguous ranges of units (ops/conv3d.py
//     _dx_s2_plan), one block of 16 warps per SM; the ring flows across
//     unit boundaries.
//   Epilogue. Each lane writes its classes' dx voxels from registers, 2
//     channels at a time: a dx voxel's 32 channels are one 64-byte run,
//     written whole by one warp's four consecutive stores. POST: each warp
//     reduces its unit's [sum du*x; sum du] over its lanes into its own
//     slot of an fp32 scratch (units x 16 warps x 64), and
//     conv3d_k3_dx_s2_dst adds the slots of each (sample, channel) in a
//     fixed order. No atomics: two runs on the same inputs give bit-equal
//     dx and dst.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned gy, y, x, w.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BD = 2, BH = 8, BW = 8;                 // brick of positions q
constexpr int FD = BD + 1, FH = BH + 1, FW = BW + 1;  // footprint q .. q + 1
constexpr int FOOT = FD * FH * FW;                    // 243 rows
constexpr int BN = 32;                                // dx channels per unit
constexpr int KC = 16;                                // Co per chunk
constexpr int ROW = KC * 2;                           // 32-byte staged rows
constexpr int THREADS = 512;
constexpr int G_BYTES = FOOT * ROW;                   // 7776
constexpr int W_BYTES = 27 * BN * ROW;                // 27648
constexpr int WARPS = THREADS / 32;
constexpr int SLOT = 2 * BN;                          // dst floats a warp
constexpr int DST_THREADS = 1024;

// a ring stage: the gy footprint, with CORR the y footprint, then the
// weights
template <bool CORR>
__host__ __device__ constexpr int stage_bytes() {
  return (CORR ? 2 : 1) * G_BYTES + W_BYTES;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece `c` of staged row `r` (the swizzle)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * ROW + ((c ^ (r >> 2)) & 1) * 16;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float post_du(float acc, float xv, float sc,
                                         float sh, float slope) {
  const float u = __fsub_rn(__fmul_rn(xv, sc), sh);
  return u >= 0.f ? acc : acc * slope;
}

// class s of warp set `set` (ops/conv3d.py DX2_CLASSES): {0, 1, 2, 7} and
// {3, 4, 5, 6}; class c = 4 p_d + 2 p_h + p_w, with 2^(p_d + p_h + p_w)
// taps
__host__ __device__ constexpr int warp_class(int set, int s) {
  return set ? 3 + s : (s == 3 ? 7 : s);
}

__host__ __device__ constexpr int class_taps(int c) {
  return 1 << ((c & 1) + ((c >> 1) & 1) + ((c >> 2) & 1));
}

// tap `t` of class c (ops/conv3d.py dx_s2_taps): along an axis of parity 0
// tap 1 at shift 0; of parity 1, by the axis's bit of t (d, h, w from the
// lowest bit), tap 0 at shift +1 (bit 0) or tap 2 at shift 0 (bit 1).
// Returns the tap index kd*9 + kh*3 + kw and the footprint row shift.
__device__ __forceinline__ void class_tap(int c, int t, int* tap,
                                          int* shift) {
  int k[3], off[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (!((c >> (2 - ax)) & 1)) {
      k[ax] = 1;
      off[ax] = 0;
    } else {
      const int b = t & 1;
      t >>= 1;
      k[ax] = b ? 2 : 0;
      off[ax] = b ? 0 : 1;
    }
  }
  *tap = (k[0] * 3 + k[1]) * 3 + k[2];
  *shift = (off[0] * FH + off[1]) * FW + off[2];
}

// the products of one chunk for the warp's MMA tile of the 4 classes of
// set SET: per class and tap, the tap's shifted footprint rows (A) times
// its weight rows w[k, ci, co] (B, already the "col" operand)
template <int SET>
__device__ __forceinline__ void class_products(float (&acc)[4][4][4],
                                               uint32_t gsm, uint32_t wsm,
                                               int a_row, int a_half,
                                               int b_row, int b_half) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int tt = 0; tt < class_taps(warp_class(SET, s)); ++tt) {
      int tap, shift;
      class_tap(warp_class(SET, s), tt, &tap, &shift);
      uint32_t af[4], bf[2][4];
      ldsm_x4(gsm + swz(a_row + shift, a_half), af);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(wsm + swz(tap * BN + 16 * j + b_row, b_half), bf[j]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma16816(acc[s][nt], af, bf[nt >> 1][(nt & 1) * 2],
                 bf[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
}

struct Geom {
  int N, D, H, W, Ci, Co;
  int Do, Ho, Wo;       // cotangent extents
  int nbh, nbw, NB;     // bricks per axis (h, w) and per sample
  int cps;              // Co chunks
};

struct Unit {
  int n, ci0, d0, h0, w0;  // sample, channel tile, brick origin (in q)
};

// unit u = (tile * N + n) * NB + brick, brick = (bd * nbh + bh) * nbw + bw,
// as _dx_s2_plan
__device__ __forceinline__ Unit decode(const Geom& g, int u) {
  Unit t;
  int b = u % g.NB;
  const int r = u / g.NB;
  t.n = r % g.N;
  t.ci0 = (r / g.N) * BN;
  t.w0 = (b % g.nbw) * BW;
  b /= g.nbw;
  t.h0 = (b % g.nbh) * BH;
  t.d0 = (b / g.nbh) * BD;
  return t;
}

// footprint row r is the cotangent voxel (brick origin) + (r_d, r_h, r_w)
__device__ __forceinline__ bool foot_inside(const Geom& g, const Unit& t,
                                            int r, size_t* vox) {
  const int d = t.d0 + r / (FH * FW), h = t.h0 + (r / FW) % FH,
            w = t.w0 + r % FW;
  if (d >= g.Do || h >= g.Ho || w >= g.Wo) return false;
  *vox = (((size_t)t.n * g.Do + d) * g.Ho + h) * g.Wo + w;
  return true;
}

__device__ __forceinline__ void stage_foot(const Geom& g, const Unit& t,
                                           int chunk, uint32_t dst,
                                           const __nv_bfloat16* src) {
  const int co0 = chunk * KC;
  for (int i = threadIdx.x; i < 2 * FOOT; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    size_t vox = 0;
    const bool in = foot_inside(g, t, r, &vox);
    cp_async16(dst + swz(r, c), src + (in ? vox * g.Co + co0 + c * 8 : 0),
               in);
  }
}

// the 27 taps' weights of the unit's 32 dx channels and the chunk's 16 co:
// row tap * 32 + ci
__device__ __forceinline__ void stage_weights(const Geom& g, const Unit& t,
                                              int chunk, uint32_t dst,
                                              const __nv_bfloat16* w) {
  const int co0 = chunk * KC;
  for (int i = threadIdx.x; i < 2 * 27 * BN; i += THREADS) {
    const int r = i >> 1, c = i & 1;
    cp_async16(dst + swz(r, c),
               w + ((size_t)(r / BN) * g.Ci + t.ci0 + r % BN) * g.Co + co0 +
                   c * 8,
               true);
  }
}

// CORR: the staged gy footprint becomes bf16(gy + gs0 + 2*y*gs1) in place,
// inside the volume only (rows past its end stay 0)
__device__ __forceinline__ void correct(const Geom& g, const Unit& t,
                                        int chunk, unsigned char* gb,
                                        const unsigned char* yb,
                                        const float* __restrict__ gs) {
  const int c = threadIdx.x & 1;
  const float* g0p = gs + (size_t)t.n * 2 * g.Co + chunk * KC + c * 8;
  float g0[8], g1[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    g0[j] = g0p[j];
    g1[j] = g0p[g.Co + j];
  }
  for (int i = threadIdx.x; i < 2 * FOOT; i += THREADS) {
    const int r = i >> 1;
    size_t vox;
    if (!foot_inside(g, t, r, &vox)) continue;
    uint4* p = reinterpret_cast<uint4*>(gb + swz(r, c));
    const uint4 yq = *reinterpret_cast<const uint4*>(yb + swz(r, c));
    uint4 q = *p;
    __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(&q);
    const __nv_bfloat162* yv = reinterpret_cast<const __nv_bfloat162*>(&yq);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(v[j]), b = __bfloat1622float2(yv[j]);
      v[j] = __floats2bfloat162_rn(
          __fadd_rn(__fadd_rn(a.x, g0[2 * j]),
                    __fmul_rn(2.f * b.x, g1[2 * j])),
          __fadd_rn(__fadd_rn(a.y, g0[2 * j + 1]),
                    __fmul_rn(2.f * b.y, g1[2 * j + 1])));
    }
    *p = q;
  }
}

struct Args {
  const __nv_bfloat16 *gy, *w, *y, *x;
  const float *gs, *pre;
  __nv_bfloat16* dx;
  float* part;
  float slope;
};

template <bool CORR, bool POST>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_k3_dx_s2_mma(Args a, Geom g, int units) {
  constexpr int STAGE = stage_bytes<CORR>();
  constexpr int W_OFF = STAGE - W_BYTES;  // the weights' offset in a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int iters = (u1 - u0) * g.cps;
  if (iters <= 0) return;

  // this warp's MMA tile (lines 2 mt and 2 mt + 1 of a class's 2 x 8
  // lines) and class set; per-lane ldmatrix coordinates as in
  // conv3d_k3_dx_s1.cu
  const int mt = warp >> 1, set = warp & 1;
  const int q = lane >> 3, r8 = lane & 7;
  const int a_line = 2 * mt + (q & 1);
  const int a_row = ((a_line / BH) * FH + a_line % BH) * FW + r8;
  const int a_half = q >> 1;
  const int b_row = 8 * (q >> 1) + r8, b_half = q & 1;

  float acc[4][4][4];  // [class slot][8-channel tile][fragment]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // prologue: the first two stages
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s < iters) {
      const Unit t = decode(g, u0 + s / g.cps);
      const uint32_t st = smem_u32(smem + s * STAGE);
      stage_foot(g, t, s % g.cps, st, a.gy);
      if (CORR) stage_foot(g, t, s % g.cps, st + G_BYTES, a.y);
      stage_weights(g, t, s % g.cps, st + W_OFF, a.w);
    }
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    unsigned char* st = smem + (it & 1) * STAGE;
    const int u = u0 + it / g.cps, chunk = it % g.cps;
    const Unit t = decode(g, u);
    cp_wait1();  // this stage's copies are done; the next stage's may not be
    __syncthreads();
    if (CORR) {
      correct(g, t, chunk, st, st + G_BYTES, a.gs);
      __syncthreads();
    }
    const uint32_t gsm = smem_u32(st);
    const uint32_t wsm = gsm + W_OFF;
    if (set)
      class_products<1>(acc, gsm, wsm, a_row, a_half, b_row, b_half);
    else
      class_products<0>(acc, gsm, wsm, a_row, a_half, b_row, b_half);

    if (chunk == g.cps - 1) {
      // epilogue of unit u: rows g and g + 8 of the tile are lines 2*mt +
      // {0, 1} at q_w = lane / 4; columns 2*(lane % 4) + {0, 1}
      const int gr = lane >> 2, tc = 2 * (lane & 3);
      const float* sc =
          POST ? a.pre + (size_t)t.n * 2 * g.Ci + t.ci0 : a.pre;
      float ssum[4][2], qsum[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ssum[j][0] = ssum[j][1] = qsum[j][0] = qsum[j][1] = 0.f;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int c = warp_class(set, s);
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const int line = 2 * mt + hv;
          const int d = 2 * (t.d0 + line / BH) + ((c >> 2) & 1),
                    h = 2 * (t.h0 + line % BH) + ((c >> 1) & 1),
                    xw = 2 * (t.w0 + gr) + (c & 1);
          if (d >= g.D || h >= g.H || xw >= g.W) continue;
          const size_t off =
              ((((size_t)t.n * g.D + d) * g.H + h) * g.W + xw) * g.Ci + t.ci0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int ci = nt * 8 + tc;
            float v0 = acc[s][nt][2 * hv], v1 = acc[s][nt][2 * hv + 1];
            if (POST) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(a.x + off + ci));
              const float du0 = post_du(v0, xv.x, sc[ci], sc[g.Ci + ci],
                                        a.slope);
              const float du1 = post_du(v1, xv.y, sc[ci + 1],
                                        sc[g.Ci + ci + 1], a.slope);
              ssum[nt][0] += du0 * xv.x;
              ssum[nt][1] += du1 * xv.y;
              qsum[nt][0] += du0;
              qsum[nt][1] += du1;
              v0 = du0 * sc[ci];
              v1 = du1 * sc[ci + 1];
            }
            *reinterpret_cast<__nv_bfloat162*>(a.dx + off + ci) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
      if (POST) {
        // this warp's [sum du*x; sum du] of unit u into its own slot
        float* slot = a.part + ((size_t)u * WARPS + warp) * SLOT;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float sv = ssum[nt][e], qv = qsum[nt][e];
#pragma unroll
            for (int m = 4; m < 32; m <<= 1) {
              sv += __shfl_xor_sync(0xffffffffu, sv, m);
              qv += __shfl_xor_sync(0xffffffffu, qv, m);
            }
            if (lane < 4) {
              slot[nt * 8 + tc + e] = sv;
              slot[BN + nt * 8 + tc + e] = qv;
            }
          }
      }
    }

    __syncthreads();  // every warp is done with this stage
    if (it + 2 < iters) {
      const int nx = it + 2;
      const Unit tn = decode(g, u0 + nx / g.cps);
      stage_foot(g, tn, nx % g.cps, smem_u32(st), a.gy);
      if (CORR) stage_foot(g, tn, nx % g.cps, smem_u32(st) + G_BYTES, a.y);
      stage_weights(g, tn, nx % g.cps, smem_u32(st) + W_OFF, a.w);
    }
    cp_commit();
  }
}

// dst[n, 0 / 1, tile * 32 + c] = the sum over the sample's bricks b and
// warps of part[((tile * N + n) * NB + b) * warps + warp][0 / 1 * 32 + c]:
// one block per (tile, sample), each thread summing every 16th slot of one
// column, then the 16 partial sums in order
__global__ void __launch_bounds__(DST_THREADS)
conv3d_k3_dx_s2_dst(const float* __restrict__ part, float* __restrict__ dst,
                    int N, int NB, int Ci) {
  constexpr int GROUPS = DST_THREADS / SLOT;
  __shared__ float red[GROUPS][SLOT];
  const int n = blockIdx.x % N, tile = blockIdx.x / N;
  const int col = threadIdx.x % SLOT, grp = threadIdx.x / SLOT;
  const long long slots = (long long)NB * WARPS;
  const float* p = part + (size_t)blockIdx.x * slots * SLOT + col;
  float s = 0.f;
  for (long long r = grp; r < slots; r += GROUPS) s += p[r * SLOT];
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < SLOT) {
    float t = 0.f;
    for (int k = 0; k < GROUPS; ++k) t += red[k][col];
    dst[((size_t)n * 2 + col / BN) * Ci + tile * BN + col % BN] = t;
  }
}

template <bool C, bool P>
cudaError_t launch_main(int grid, cudaStream_t st, const Args& a,
                        const Geom& g, int units) {
  const int smem = 2 * stage_bytes<C>();
  cudaError_t e = cudaFuncSetAttribute(
      conv3d_k3_dx_s2_mma<C, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  conv3d_k3_dx_s2_mma<C, P><<<grid, THREADS, smem, st>>>(a, g, units);
  return cudaGetLastError();
}

}  // namespace

// Launches dx = conv_backward_input(gy, w) at stride 2 on `stream` over
// `grid` persistent blocks (ops/conv3d.py _dx_s2_plan); dx is (N, D, H, W,
// Ci), gy (N, (D-1)/2+1, (H-1)/2+1, (W-1)/2+1, Co). y and gs (CORR) come
// together or are both null; so do x, pre, dst and part (POST). dst
// (N, 2, Ci) is written, not added to; part is an fp32 scratch of units x
// 16 warps x 64 floats (units = Ci / 32 x N x bricks of 2 x 8 x 8
// cotangent voxels). Returns the CUDA error code of the launches (0 on
// success).
extern "C" int conv3d_k3_dx_s2_ndhwc_launch(
    const void* gy, const void* w, const void* y, const void* gs,
    const void* x, const void* pre, void* dx, void* dst, void* part, int N,
    int D, int H, int W, int Ci, int Co, int grid, float slope,
    void* stream) {
  const bool corr = y != nullptr, post = pre != nullptr;
  if (Ci % BN != 0 || Co % (2 * KC) != 0 || N < 1 || D < 1 || H < 1 ||
      W < 1 || grid < 1 || corr != (gs != nullptr) ||
      post != (x != nullptr) || post != (dst != nullptr) ||
      post != (part != nullptr))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.Do = (D - 1) / 2 + 1, g.Ho = (H - 1) / 2 + 1, g.Wo = (W - 1) / 2 + 1;
  const int nbd = (g.Do + BD - 1) / BD;
  g.nbh = (g.Ho + BH - 1) / BH;
  g.nbw = (g.Wo + BW - 1) / BW;
  g.NB = nbd * g.nbh * g.nbw;
  g.cps = Co / KC;
  const long long units = (long long)(Ci / BN) * N * g.NB;
  if (units * WARPS * SLOT > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (grid > units) grid = (int)units;
  const Args a{static_cast<const __nv_bfloat16*>(gy),
               static_cast<const __nv_bfloat16*>(w),
               static_cast<const __nv_bfloat16*>(y),
               static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(gs),
               static_cast<const float*>(pre),
               static_cast<__nv_bfloat16*>(dx),
               static_cast<float*>(part),
               slope};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (corr)
    e = post ? launch_main<true, true>(grid, st, a, g, (int)units)
             : launch_main<true, false>(grid, st, a, g, (int)units);
  else
    e = post ? launch_main<false, true>(grid, st, a, g, (int)units)
             : launch_main<false, false>(grid, st, a, g, (int)units);
  if (e != cudaSuccess || !post) return (int)e;
  conv3d_k3_dx_s2_dst<<<N * (Ci / BN), DST_THREADS, 0, st>>>(
      a.part, static_cast<float*>(dst), N, g.NB, Ci);
  return (int)cudaGetLastError();
}
