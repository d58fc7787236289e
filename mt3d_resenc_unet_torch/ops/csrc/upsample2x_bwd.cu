// Backward of the 2x2x2 stride-2 transposed convolution (kernel == stride)
// on NDHWC bf16, on the tensor cores, for Hopper (sm_90a). Plain C
// interface, bound with ctypes (ops/upsample.py upsample2x_dx and
// upsample2x_dw).
//
// Replaces the TPU's Pallas kernels
//   mt3d_resenc_unet_tpu/ops/pallas_upsample.py::_dx_kernel and ::_dw_kernel
//   (the backward of upsample2x_packed, _upsample_bwd)
// without their lane packing. For the forward
//   y[n, 2i+a, 2j+b, 2k+c, :] = x[n, i, j, k, :] @ Wf[a, b, c]
// (Wf flipped by the caller) they compute, with p = (a, b, c) = 4a + 2b + c:
//   dx[n, i, j, k, ci] = sum_{p, co} gy[n, 2i+a, 2j+b, 2k+c, co] Wf[p, ci, co]
//   dWf[p, ci, co]     = sum_{n, i, j, k} x[n, i, j, k, ci] gy[.., co]   (fp32)
//
// What bounds them on the H100: bytes. At the flagship's 128->64 (from
// 32^3) and 64->32 (from 64^3), N=2, each reads gy once (67 / 268 MB) and x
// or writes dx (17 / 67 MB): 84 / 335 MB, 25 / 100 us of HBM, against 8.6 /
// 17.2 GFLOP, 9 / 17 us of bf16 tensor-core peak (~51 FLOP per byte, far
// under the ~295 where the tensor cores become the limit).
//
// Both are GEMMs on mma.sync.m16n8k16 (T in, fp32 accumulate), fed by a
// cp.async ring, over coarse-voxel tiles of VH x 16 voxels of one (n, d).
// Staging gy by parity. For the 16 coarse voxels k0 .. k0+15 of one coarse
// row (n, d, h) and one (a, b), the fine rows gy[n, 2d+a, 2h+b, 2k0 ..
// 2k0+31, :] are one contiguous segment. Each is read once, as 16-byte
// pieces, and written to shared memory de-interleaved: fine row 2k + c goes
// to staged row (c * VH + hh) * 16 + k - k0 of its (a, b) (ops/upsample.py
// up2_row, tested on the CPU). So for every parity p the tile's voxels are
// consecutive staged rows, and an ldmatrix phase of 8 rows of one parity
// reads 8 consecutive rows. Rows are XOR-swizzled by row (swz) so that any
// 8 consecutive rows hit 8 distinct bank groups.
//
// dW (upsample2x_dw_ndhwc_mma): dWf[p] (Ci x Co) = X^T G_p, K = voxels.
//   ldmatrix.trans gives X^T (rows ci) from the voxel-major staged x and
//   G_p (k = voxel, n = co) from the staged gy, as in conv3d_k3_dw_s1.cu.
//   A block owns a tile of PB parities x TCI ci x TCO co (ops/upsample.py
//   _up_bwd_plan): at 64->32 all 8 parities x 64 x 32 (one warp per
//   parity, 64 sums a thread), so x and gy are each read exactly once; at
//   128->64 the 65,536 sums do not fit one block's registers, so a block
//   takes the 2 parities of one (a, b) x 128 x 64 (warp = (c, 32 ci)): gy,
//   the larger operand, is still read once, x (16.8 MB) 4 times. Any other
//   channels take 8 parities x 32 x 32 tiles. K is a run of 64-voxel chunks
//   (4 x 16 coarse voxels of one (n, d)) in a 4-stage ring; splits x tiles
//   blocks fill the SMs once. Each chunk's products go to a fresh fragment
//   that is then added to an fp32 register sum (a chain of 4 MMAs), so the
//   tensor cores' truncating fp32 accumulation never runs a long chain.
//   Each block stores its partial tile to its own slice of an fp32
//   (splits, 8, Ci, Co) scratch; upsample2x_dw_ndhwc_sum adds the slices in
//   split order. No atomics: two runs give bit-equal dW.
// dx (upsample2x_dx_ndhwc_mma): dx (voxels x Ci) = sum_p G_p Wf[p]^T,
//   K = 8 x Co. A block owns TM voxels x TCI ci (128 x 128 at 128->64,
//   256 x 64 at 64->32, so all of Ci and gy is read once; 128 x 32
//   otherwise), 8 warps of (TM / 4) x (TCI / 2). A is the staged gy with
//   plain ldmatrix (rows voxels, k = co contiguous); B is Wf[p] as stored,
//   (Ci, Co) with co contiguous, which is the "col" operand of mma.sync
//   row.col, so plain ldmatrix loads it too. The block's weights (8 x TCI x
//   Co bf16: 128 KB / 32 KB at the flagship) stay resident in shared
//   memory; the ring streams gy in stages of one (a, b) x KC co (whole
//   64-channel rows in 3 stages at 128->64, 32 channels in 6 at 64->32).
//   Blocks are persistent and walk a range of tiles, the ring flowing
//   across tiles so one tile's epilogue overlaps the next one's loads. The
//   epilogue rounds to bf16 into the stage just consumed and stores it as
//   16-byte rows.
// Copies. Each thread's pieces of a tile (offsets from the tile's base and
//   staged addresses) are the same for every tile, so they are computed
//   once per kernel (Slots); a tile costs one base address, and the edge
//   test runs only where a tile crosses the volume's edge.
//
// Requirements (checked by the wrapper and here): Ci % 32 == 0,
// Co % 32 == 0, contiguous 16-byte aligned x, gy, wf; for dx with 32-ci
// tiles Co <= 256 (the resident weights).
//
// T, the operand type, is bf16 or fp16 (b16.cuh); "bf16" below stands
// for T, and the launcher's dtype code picks it.

#include "b16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int VW = 16;                 // coarse voxels of a tile along w
constexpr int DW_VH = 4;               // dW chunk: 4 x 16 voxels of (n, d)
constexpr int DW_VOX = DW_VH * VW;     // 64: K per dW stage
constexpr int DW_STAGES = 4;
constexpr int SUM_THREADS = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte piece j of row r in rows of P pieces (P % 4 ==
// 0): the piece index is XORed with the row so that 8 consecutive rows
// (from an even row) hit 8 distinct bank groups
__device__ __forceinline__ uint32_t swz(int r, int j, int P) {
  const int s = (P & 7) ? ((j & ~3) | ((j ^ (r >> 1)) & 3))
                        : ((j & ~7) | ((j ^ r) & 7));
  return (uint32_t)(r * P + s) * 16u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

struct Geom {
  int N, D, H, W, Ci, Co;  // coarse extents and channels
  int nhg, nwg;            // tiles along h and w
};

struct Tile {
  int n, d, h0, w0;
};

// tile t = ((n * D + d) * nhg + hg) * nwg + wg, of vh x VW coarse voxels
__device__ __forceinline__ Tile decode(const Geom& g, int t, int vh) {
  Tile r;
  r.w0 = (t % g.nwg) * VW;
  t /= g.nwg;
  r.h0 = (t % g.nhg) * vh;
  t /= g.nhg;
  r.d = t % g.D;
  r.n = t / g.D;
  return r;
}

// gy of a tile, relative to gy[n, 2d, 2h0, 2w0, 0]: element offsets of
// fine row (2d + a, 2h0 + 2hh + b) are a * plane + (2hh + b) * row
__device__ __forceinline__ size_t gy_base(const Geom& g, const Tile& t) {
  return (((size_t)t.n * 2 * g.D + 2 * t.d) * 2 * g.H + 2 * t.h0) *
             (size_t)(2 * g.W) * g.Co + (size_t)2 * t.w0 * g.Co;
}

// A thread's share of a tile's copies, fixed for the kernel: piece i =
// k * THREADS + threadIdx.x of the tile's K pieces, as an element offset
// from the tile's base, its byte offset in the stage, and its coarse (hh,
// w) in the tile (hh << 8 | w) for the ragged edge. gy pieces (hh, f, j)
// of (a, b) number abl: fine w index f of coarse row hh, 16-byte piece j
// of the P staged; staged de-interleaved by c = f & 1 (up2_row).
template <int K>
struct Slots {
  int rel[K];
  uint32_t dst[K];
  int hw[K];
};

template <int K, int P>
__device__ __forceinline__ void gy_slots(const Geom& g, int vh, int ab0,
                                         Slots<K>& s) {
  const int row = 2 * g.W * g.Co, plane = 2 * g.H * row;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * THREADS + threadIdx.x;
    const int j = i % P, f = (i / P) % (2 * VW), hh = (i / (P * 2 * VW)) % vh;
    const int abl = i / (P * 2 * VW * vh), ab = ab0 + abl;
    s.rel[k] = (ab >> 1) * plane + (2 * hh + (ab & 1)) * row + f * g.Co +
               8 * j;
    s.dst[k] = swz(abl * 2 * vh * VW + ((f & 1) * vh + hh) * VW + (f >> 1), j,
                   P);
    s.hw[k] = (hh << 8) | (f >> 1);
  }
}

// cp.async a tile's pieces from src (the tile's base) to stage address
// `to`; pieces outside the volume are zero-filled
template <class T, int K>
__device__ __forceinline__ void copy_slots(const Geom& g, const Tile& t,
                                           int vh, const Slots<K>& s,
                                           const T* src,
                                           const T* any,
                                           uint32_t to) {
  const bool full = t.h0 + vh <= g.H && t.w0 + VW <= g.W;
  const int hl = g.H - t.h0, wl = g.W - t.w0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool in = full || ((s.hw[k] >> 8) < hl && (s.hw[k] & 255) < wl);
    cp_async16(to + s.dst[k], in ? src + s.rel[k] : any, in);
  }
}

// ---------------------------------------------------------------- dW

template <int TCI, int TCO, int PB>
struct DwCfg {
  static constexpr int WPP = 8 / PB;          // warps per parity
  static constexpr int WM = TCI / WPP;        // ci per warp
  static constexpr int MT = WM / 16, NT = TCO / 8;
  static constexpr int PX = TCI / 8, PG = TCO / 8;  // pieces per row
  static constexpr int X_BYTES = DW_VOX * TCI * 2;
  static constexpr int G_BYTES = PB * DW_VOX * TCO * 2;
  static constexpr int STAGE = X_BYTES + G_BYTES;
  static constexpr int SMEM = DW_STAGES * STAGE;
  static constexpr int KX = DW_VOX * PX / THREADS;           // x pieces
  static constexpr int KG = PB / 2 * DW_VH * 2 * VW * PG / THREADS;
};

template <class T, int TCI, int TCO, int PB>
__global__ void __launch_bounds__(THREADS, 1)
upsample2x_dw_ndhwc_mma(const T* __restrict__ x,
                        const T* __restrict__ gy,
                        float* __restrict__ part, Geom g, int splits,
                        int chunks) {
  using C = DwCfg<TCI, TCO, PB>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ntci = g.Ci / TCI, ntco = g.Co / TCO;
  const int tiles = (8 / PB) * ntci * ntco;
  const int tile = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int pg = tile / (ntci * ntco);
  const int ci0 = ((tile / ntco) % ntci) * TCI, co0 = (tile % ntco) * TCO;
  const int c0 = (int)((long long)split * chunks / splits);
  const int iters = (int)((long long)(split + 1) * chunks / splits) - c0;
  // this warp: parity pw of the group, ci [ciw, ciw + WM) of the tile
  const int pw = warp / C::WPP, ciw = (warp % C::WPP) * C::WM;
  // ldmatrix.trans lanes. A (x): matrices q = (k half q >> 1, ci half
  // q & 1); B (gy): matrices q = (k half q & 1, co half q >> 1)
  const int q = lane >> 3, r8 = lane & 7;
  const int a_line = q >> 1, a_c = q & 1, b_line = q & 1, b_c = q >> 1;

  // this thread's copies of a chunk: x rows (hh, w) of the tile's ci, and
  // the group's (a, b) fine rows of its co
  Slots<C::KX> xsl;
#pragma unroll
  for (int k = 0; k < C::KX; ++k) {
    const int i = k * THREADS + threadIdx.x, r = i / C::PX, j = i % C::PX;
    xsl.rel[k] = ((r / VW) * g.W + r % VW) * g.Ci + 8 * j;
    xsl.dst[k] = swz(r, j, C::PX);
    xsl.hw[k] = ((r / VW) << 8) | (r % VW);
  }
  Slots<C::KG> gsl;
  gy_slots<C::KG, C::PG>(g, DW_VH, pg * (PB / 2), gsl);
  auto stage = [&](int chunk, int slot) {
    const Tile t = decode(g, chunk, DW_VH);
    const uint32_t xs = smem_u32(smem + slot * C::STAGE);
    copy_slots(g, t, DW_VH, xsl,
               x + ((((size_t)t.n * g.D + t.d) * g.H + t.h0) * g.W + t.w0) *
                       g.Ci + ci0, x, xs);
    copy_slots(g, t, DW_VH, gsl, gy + gy_base(g, t) + co0, gy,
               xs + C::X_BYTES);
  };

  float sum[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < DW_STAGES - 1; ++s) {
    if (s < iters) stage(c0 + s, s);
    cp_commit();
  }

  for (int it = 0; it < iters; ++it) {
    cp_wait<DW_STAGES - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    const int nx = it + DW_STAGES - 1;
    if (nx < iters) stage(c0 + nx, nx % DW_STAGES);
    cp_commit();
    const uint32_t xs = smem_u32(smem + (it % DW_STAGES) * C::STAGE);
    const uint32_t gs = xs + C::X_BYTES;
    float acc[C::MT][C::NT][4];
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < DW_VOX / 16; ++s) {
      uint32_t b[C::NT / 2][4];
#pragma unroll
      for (int j = 0; j < C::NT / 2; ++j)
        ldsm_x4_t(gs + swz(pw * DW_VOX + 16 * s + 8 * b_line + r8, 2 * j + b_c,
                           C::PG),
                  b[j]);
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt) {
        uint32_t a[4];
        ldsm_x4_t(xs + swz(16 * s + 8 * a_line + r8, (ciw + 16 * mt) / 8 + a_c,
                           C::PX),
                  a);
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt)
          mma16816<T>(acc[mt][nt], a, b[nt >> 1][(nt & 1) * 2],
                      b[nt >> 1][(nt & 1) * 2 + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[i][j][e] += acc[i][j][e];
  }

  // sum[mt][nt][e]: ci = ciw + 16 mt + lane / 4 + 8 (e >> 1), co = 8 nt +
  // 2 (lane % 4) + (e & 1); this block's slice of the scratch
  const int gr = lane >> 2, tc = 2 * (lane & 3);
  float* out = part + ((size_t)split * 8 + pg * PB + pw) * g.Ci * g.Co;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            out + (size_t)(ci0 + ciw + 16 * mt + gr + 8 * h) * g.Co + co0 +
            8 * nt + tc) = make_float2(sum[mt][nt][2 * h],
                                       sum[mt][nt][2 * h + 1]);
}

// dw[i] = sum over s in order of part[s][i], i over the 8 * Ci * Co values
__global__ void __launch_bounds__(SUM_THREADS)
upsample2x_dw_ndhwc_sum(const float* __restrict__ part, float* __restrict__ dw,
                        long long size, int splits) {
  const long long i = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[k * size + i];
  dw[i] = s;
}

// ---------------------------------------------------------------- dx

template <int TM, int TCI, int KC, int S>
struct DxCfg {
  static constexpr int VH = TM / VW;
  static constexpr int WTM = TM / 4, WTN = TCI / 2;  // 4 x 2 warps
  static constexpr int MT = WTM / 16, NT = WTN / 8;
  static constexpr int PK = KC / 8;                  // pieces of a gy row
  static constexpr int PO = TCI / 8;                 // pieces of a dx row
  static constexpr int STAGE = 2 * TM * KC * 2;      // parities c of (a, b)
  static constexpr int KG = VH * 2 * VW * PK / THREADS;
  static_assert(TM * TCI * 2 <= STAGE, "the output tile reuses a stage");
  static int smem(int Co) { return 8 * TCI * Co * 2 + S * STAGE; }
};

template <class T, int TM, int TCI, int KC, int S>
__global__ void __launch_bounds__(THREADS, 1)
upsample2x_dx_ndhwc_mma(const T* __restrict__ gy,
                        const T* __restrict__ wf,
                        T* __restrict__ dx, Geom g, int units) {
  using C = DxCfg<TM, TCI, KC, S>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int PW = g.Co / 8;                       // pieces of a weight row
  const int ci0 = blockIdx.y * TCI;
  const uint32_t ws = smem_u32(smem);
  unsigned char* ring = smem + 8 * TCI * g.Co * 2;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int nkc = g.Co / KC, kpu = 4 * nkc;      // stages per tile
  const int iters = (u1 - u0) * kpu;
  if (iters <= 0) return;

  const int wm = warp >> 1, wn = warp & 1;
  const int q = lane >> 3, r8 = lane & 7;
  const int row = 2 * g.W * g.Co, plane = 2 * g.H * row;

  // the block's weights Wf[p, ci0 .. ci0 + TCI, :], rows (p, ci), resident
  for (int i = threadIdx.x; i < 8 * TCI * PW; i += THREADS) {
    const int j = i % PW, r = i / PW;
    cp_async16(ws + swz(r, j, PW),
               wf + ((size_t)(r / TCI) * g.Ci + ci0 + r % TCI) * g.Co + 8 * j,
               true);
  }
  // this thread's copies of a stage: (a, b) = (0, 0) and cotangent
  // channels 0 .. KC; a stage of (a, b) and chunk kc adds a * plane +
  // b * row + kc * KC
  Slots<C::KG> gsl;
  gy_slots<C::KG, C::PK>(g, C::VH, 0, gsl);
  // iteration it: tile u0 + it / kpu, (a, b) = (it % kpu) / nkc, cotangent
  // channels KC * ((it % kpu) % nkc) ..
  auto stage = [&](int i, int slot) {
    const Tile t = decode(g, u0 + i / kpu, C::VH);
    const int k = i % kpu, ab = k / nkc;
    copy_slots(g, t, C::VH, gsl,
               gy + gy_base(g, t) + (ab >> 1) * plane + (ab & 1) * row +
                   KC * (k % nkc),
               gy, smem_u32(ring + slot * C::STAGE));
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < iters) stage(s, s);
    cp_commit();
  }

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int it = 0; it < iters; ++it) {
    cp_wait<S - 2>();
    __syncthreads();  // stage it landed; every warp is done with it - 1
    if (it + S - 1 < iters) stage(it + S - 1, (it + S - 1) % S);
    cp_commit();
    const int k = it % kpu, ab = k / nkc, kc = k % nkc;
    unsigned char* st = ring + (it % S) * C::STAGE;
    const uint32_t gs = smem_u32(st);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int p = 2 * ab + c;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // B (Wf[p] rows ci): matrices q = (ci half q >> 1, k half q & 1)
        uint32_t b[C::NT / 2][4];
#pragma unroll
        for (int j = 0; j < C::NT / 2; ++j)
          ldsm_x4(ws + swz(p * TCI + wn * C::WTN + 16 * j + 8 * (q >> 1) + r8,
                           kc * C::PK + 2 * ks + (q & 1), PW),
                  b[j]);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          // A (gy rows of parity c): matrices q = (row half q & 1, k half
          // q >> 1)
          uint32_t a[4];
          ldsm_x4(gs + swz(c * TM + wm * C::WTM + 16 * mt + 8 * (q & 1) + r8,
                           2 * ks + (q >> 1), C::PK),
                  a);
#pragma unroll
          for (int nt = 0; nt < C::NT; ++nt)
            mma16816<T>(acc[mt][nt], a, b[nt >> 1][(nt & 1) * 2],
                        b[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }
    if (k != kpu - 1) continue;

    // epilogue of the tile: bf16 into this stage's slot once every warp is
    // done with it (it is refilled only after the next iteration's
    // barrier), then 16-byte rows
    __syncthreads();
    const Tile t = decode(g, u0 + it / kpu, C::VH);
    const int gr = lane >> 2, tc = 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wm * C::WTM + 16 * mt + gr + 8 * h;
          const int col = wn * C::WTN + 8 * nt;
          *reinterpret_cast<b16x2<T>*>(st + swz(r, col / 8, C::PO) +
                                             2 * tc) =
              pack2<T>(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
          acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
        }
    __syncthreads();
    for (int i = threadIdx.x; i < TM * C::PO; i += THREADS) {
      const int r = i / C::PO, j = i % C::PO;
      const int h = t.h0 + r / VW, w = t.w0 + r % VW;
      if (h < g.H && w < g.W)
        *reinterpret_cast<uint4*>(
            dx + ((((size_t)t.n * g.D + t.d) * g.H + h) * g.W + w) * g.Ci +
            ci0 + 8 * j) =
            *reinterpret_cast<const uint4*>(st + swz(r, j, C::PO));
    }
  }
}

Geom make_geom(int N, int D, int H, int W, int Ci, int Co, int vh) {
  Geom g;
  g.N = N, g.D = D, g.H = H, g.W = W, g.Ci = Ci, g.Co = Co;
  g.nhg = (H + vh - 1) / vh;
  g.nwg = (W + VW - 1) / VW;
  return g;
}

template <class T, int TCI, int TCO, int PB>
cudaError_t launch_dw(int grid, cudaStream_t st, const void* x,
                      const void* gy, void* part, const Geom& g, int splits,
                      int chunks) {
  using C = DwCfg<TCI, TCO, PB>;
  cudaError_t e = cudaFuncSetAttribute(
      upsample2x_dw_ndhwc_mma<T, TCI, TCO, PB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  upsample2x_dw_ndhwc_mma<T, TCI, TCO, PB><<<grid, THREADS, C::SMEM, st>>>(
      static_cast<const T*>(x),
      static_cast<const T*>(gy), static_cast<float*>(part), g,
      splits, chunks);
  return cudaGetLastError();
}

template <class T, int TM, int TCI, int KC, int S>
cudaError_t launch_dx(dim3 grid, cudaStream_t st, const void* gy,
                      const void* wf, void* dx, const Geom& g, int units) {
  const int smem = DxCfg<TM, TCI, KC, S>::smem(g.Co);
  cudaError_t e = cudaFuncSetAttribute(
      upsample2x_dx_ndhwc_mma<T, TM, TCI, KC, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  upsample2x_dx_ndhwc_mma<T, TM, TCI, KC, S><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(gy),
      static_cast<const T*>(wf), static_cast<T*>(dx),
      g, units);
  return cudaGetLastError();
}

}  // namespace

// dx (N, Di, Hi, Wi, Ci) bf16 from gy (N, 2Di, 2Hi, 2Wi, Co) and wf
// (2, 2, 2, Ci, Co) flipped, in tiles of tci input channels (128 with
// Co == 64, 64 with Co == 32, else 32 with Co <= 256; ops/upsample.py
// _up_bwd_plan) over `grid` persistent blocks per ci tile. Returns the
// cudaGetLastError() code.
extern "C" int upsample2x_dx_ndhwc_launch(const void* gy, const void* wf,
                                          void* dx, int N, int Di, int Hi,
                                          int Wi, int Ci, int Co, int tci,
                                          int grid, int dtype, void* stream) {
  return b16_dispatch(dtype, [&](auto t) -> int {
    using T = decltype(t);
    const bool ok = (tci == 128 && Co == 64) || (tci == 64 && Co == 32) ||
                    (tci == 32 && Co <= 256);
    if (!ok || Ci % tci != 0 || Co % 32 != 0 || N < 1 || Di < 1 || Hi < 1 ||
        Wi < 1 || grid < 1 || 8LL * Hi * Wi * Co > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const int tm = tci == 64 ? 256 : 128;
    const Geom g = make_geom(N, Di, Hi, Wi, Ci, Co, tm / VW);
    const long long units = (long long)N * Di * g.nhg * g.nwg;
    if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const dim3 blocks((unsigned)(grid < units ? grid : units), Ci / tci);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (tci == 128)
      e = launch_dx<T, 128, 128, 64, 3>(blocks, st, gy, wf, dx, g, (int)units);
    else if (tci == 64)
      e = launch_dx<T, 256, 64, 32, 6>(blocks, st, gy, wf, dx, g, (int)units);
    else
      e = launch_dx<T, 128, 32, 32, 6>(blocks, st, gy, wf, dx, g, (int)units);
    return (int)e;
  });
}

// dw = the (8, Ci, Co) fp32 weight gradient of the flipped wf from x
// (N, Di, Hi, Wi, Ci) and gy (N, 2Di, 2Hi, 2Wi, Co), written, not added
// to. Tiles of (tci, tco) = (64, 32) with 8 parities a block, (128, 64)
// with the 2 parities of one (a, b), or (32, 32) with 8 (ops/upsample.py
// _up_bwd_plan); the 64-voxel chunks split `splits` ways. part is an fp32
// scratch of splits x 8 x Ci x Co. Returns the cudaGetLastError() code.
extern "C" int upsample2x_dw_ndhwc_launch(const void* x, const void* gy,
                                          void* dw, void* part, int N, int Di,
                                          int Hi, int Wi, int Ci, int Co,
                                          int tci, int tco, int splits,
                                          int dtype, void* stream) {
  return b16_dispatch(dtype, [&](auto t) -> int {
    using T = decltype(t);
    const bool ok = (tci == 64 && tco == 32) || (tci == 128 && tco == 64) ||
                    (tci == 32 && tco == 32);
    if (!ok || Ci % tci != 0 || Co % tco != 0 || N < 1 || Di < 1 || Hi < 1 ||
        Wi < 1 || splits < 1 || !part || 8LL * Hi * Wi * Co > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const Geom g = make_geom(N, Di, Hi, Wi, Ci, Co, DW_VH);
    const long long chunks = (long long)N * Di * g.nhg * g.nwg;
    const int pb = tco == 64 ? 2 : 8;
    const long long blocks =
        (long long)(8 / pb) * (Ci / tci) * (Co / tco) * splits;
    if (chunks > 0x7fffffff || blocks > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e;
    if (tco == 64)
      e = launch_dw<T, 128, 64, 2>((int)blocks, st, x, gy, part, g, splits,
                                (int)chunks);
    else if (tci == 64)
      e = launch_dw<T, 64, 32, 8>((int)blocks, st, x, gy, part, g, splits,
                               (int)chunks);
    else
      e = launch_dw<T, 32, 32, 8>((int)blocks, st, x, gy, part, g, splits,
                               (int)chunks);
    if (e != cudaSuccess) return (int)e;
    const long long size = 8LL * Ci * Co;
    upsample2x_dw_ndhwc_sum<<<(unsigned)((size + SUM_THREADS - 1) / SUM_THREADS),
                              SUM_THREADS, 0, st>>>(
        static_cast<const float*>(part), static_cast<float*>(dw), size, splits);
    return (int)cudaGetLastError();
  });
}
