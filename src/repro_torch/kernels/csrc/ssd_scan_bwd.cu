// Backward of the Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a): the
// gradients that training the hybrid family takes through its Mamba2 layers.
//
// Replaces: the gradient of src/repro/kernels/ssd_scan.py's ssd_scan_kernel
// (Pallas, TPU), which the JAX package takes by differentiating its jnp form
// (src/repro/models/ssm.py, ssd_chunked); the TPU kernel has no backward.
// Given dy (b, l, h, p) and, optionally, the final state's gradient dfinal
// (b, h, p, n), it returns dx, da, dB, dC and dinit, per (batch, head) and
// chunk of 128 steps, with cs the chunk's cumulative log-decay, total =
// cs[last], w = exp(total - cs), prev the state before the chunk (p x n),
// G[i,j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i:
//   loc    = (dy exp(cs))^T C                 the chunk's own d prev
//   dS_c   = g_{c+1};  g_c = loc_c + g_{c+1} exp(total_c);  g_nc = dfinal,
//            dinit = g_0                      (dS: d of the state after c)
//   dx     = G^T dy + w (B dS^T)
//   ds     = (dy x^T) exp(cs_i - cs_j), j <= i
//   dC     = sum over heads of ds B + exp(cs) (dy prev)
//   dB     = sum over heads of ds^T C + w (x dS)
//   dcs_i  = sum_j M[i,j] - sum_j M[j,i] + exp(cs_i) C_i . (dy prev)_i
//            - w_i B_i . (x dS)_i, with M = ds * (C B^T), and at the last
//            step + sum_j w_j B_j . (x dS)_j + exp(total) sum(dS * prev)
//   da     = the reverse cumulative sum of dcs within the chunk.
// It reads the forward's scratch (ssd_scan.cu's first two passes): the
// state before each chunk, cs, and C B^T of each chunk, which training keeps
// from the forward.  Layouts are the forward's; all f32, contiguous, 16-byte
// aligned; p and n multiples of 4, at most 64.  A ragged last chunk reads
// its missing steps as x = dy = B = C = 0; its cs there is the forward's
// (a = 0, so cs stays at its last real value).
//
// What bounds it on an H100: at zamba2-7b's largest prefill bucket (b = 1,
// l = 1024, h = 112, p = n = 64) the gradients from the forward's scratch
// need ~7.5 GFLOP: per head and chunk the lower triangles of dy x^T, G^T
// dy, ds B and ds^T C, and four (128 x 64 x 64) products (loc, dy prev, x
// dS and B dS^T).  As IEEE f32 FMAs that is ~0.11 ms at 67 TFLOP/s (~0.13
// ms for the whole function, which also makes each chunk's state and C
// B^T); as 3xTF32 tensor-core products (hi.hi + hi.lo + lo.hi, which keep
// the tolerance: tests/test_torch_ssd_bwd.py) three times the operations
// at 495 TFLOP/s, ~0.05 ms.  Its ~105 MB of inputs, scratch and outputs
// take ~0.03 ms at 3.35 TB/s.  Bound by operations either way.
//
// What this design does about it: it runs no forward pass (the scratch is
// kept from the forward), makes no C B^T (the forward's, read in the order
// its threads hold it), and no per-head dB and dC in device memory.  Every
// product is an IEEE f32 FMA with both operands as float4 loads from shared
// memory: a thread holds 8 rows by 4 columns of each (128 x 64) product
// (twelve 16-byte loads for 128 FMAs along a contraction of 64, three or
// six for 32 or 64 along a triangle) and 36 pairs of each (128 x 128) one;
// the triangles are cut at the diagonal, a thread's rows being two runs of
// four mirrored about the middle of the chunk, so that every thread has
// the same share of each.  Three launches on the caller's stream, every
// kernel named "ssd_":
// 1. ssd_bwd_states, one CTA per (head, batch), over the chunks from the
//    last: loc^T (n, p), then dS_c = g and g = loc + g exp(total_c), g in
//    registers; the next chunk's C and dy arrive by cp.async meanwhile.
// 2. ssd_bwd_chunk, one CTA per (chunk, group of heads, batch), 225 KB of
//    shared memory: B and C of the chunk once for the group; each head's x,
//    dy, cs and states, the next head's arriving by cp.async while this one
//    computes; two packed triangles that hold prev^T and dS^T, then ds, and
//    dS, then G, then ds^T.  dB and dC are summed over the group's heads in
//    registers, in the heads' order, and written once per group; da comes
//    from one warp's scan of the chunk's decay gradient.
// 3. ssd_bwd_group_sum: dB and dC summed over the groups in order (not
//    launched for a single group).
// The heads per CTA come from the shape and the SM count (ssd_bwd_plan in
// the wrapper).  No atomics, and every sum runs in a fixed order, so no
// result depends on scheduling.
// Not done yet: the tensor cores.  3xTF32 on wgmma reads both operands
// K-major from shared memory, hi and lo apart: the B operands alone (x,
// prev^T, dS^T, dS for the dense products; dy^T, B^T, C^T for the
// triangles) are twice these f32 tiles, beyond the 227 KB a CTA may use
// beside B, C, x and dy, and its accumulators' layout is not the FMA
// tiles'.  The FMA products reach about half the FMA rate: one CTA of 8
// warps fits an SM (shared memory), and 255 registers a thread hold the
// group's dB and dC.  Also TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;        // steps per chunk
constexpr int THREADS = 256;
constexpr int MAX_DIM = 64;   // p and n
constexpr int PD = MAX_DIM + 4;  // pitch of a (128 x 64) tile in shared
constexpr int CB_FLOATS = 36 * 256;  // a chunk's C B^T (ssd_scan.cu)

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float get(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 16 bytes global -> shared, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows of one chunk of a (b, l, H, K) tensor (head h) or a (b, l, K) one
// (H = 1, h = 0) into a [L][PD] shared tile by cp.async (no commit):
// columns past K and rows past Lc are zero
__device__ void issue_rows(float* dst, const float* src, size_t row0, int Lc,
                           int H, int h, int K) {
  for (int e = threadIdx.x; e < L * (MAX_DIM / 4); e += THREADS) {
    const int t = e / (MAX_DIM / 4), k = (e % (MAX_DIM / 4)) * 4;
    const bool ok = t < Lc && k < K;
    cp_async16(&dst[t * PD + k],
               ok ? src + ((row0 + t) * H + h) * K + k : src, ok);
  }
}

// ---- pass 1: the state gradients, across the chunks in reverse --------

// shared memory, in floats: two slots of C [L][PD], dy [L][PD], cs [L] and
// exp(cs) [L]
constexpr size_t STATES_SLOT = 2 * size_t(L) * PD + 2 * L;
constexpr size_t STATES_SMEM_FLOATS = 2 * STATES_SLOT;

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One CTA per (head, batch), over the chunks from the last: each chunk's
// own gradient of the state before it, loc^T[n][p] = sum_i exp(cs_i)
// C[i][n] dy[i][p], then dS_c = g (written as S^T), g = loc + g
// exp(total_c), from g = dfinal (or 0); dinit (b, h, p, n) = the last g.
// Thread (n0 .. + 4, p0 .. + 4) keeps its part of g in registers; the next
// chunk's C, dy and cs arrive by cp.async while this one computes.
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_states(const float* __restrict__ dy, const float* __restrict__ Cm,
               const float* __restrict__ cs, const float* __restrict__ dfinal,
               float* __restrict__ g, float* __restrict__ dinit, int l,
               int nc, int H, int P, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int n0 = (tid / 16) * 4, p0 = (tid % 16) * 4;
  const size_t bh = size_t(b) * H + h;
  // chunk c into slot c & 1 (no commit): C and dy rows, and cs
  auto issue = [&](int c) {
    float* Cs = smem + (c & 1) * STATES_SLOT;
    float* Ds = Cs + L * PD;
    float* cv = Ds + L * PD;
    const int Lc = min(L, l - c * L);
    const size_t row0 = size_t(b) * l + size_t(c) * L;
    for (int e = tid; e < L * (MAX_DIM / 4); e += THREADS) {
      const int t = e / (MAX_DIM / 4), k = (e % (MAX_DIM / 4)) * 4;
      const bool okc = t < Lc && k < N, okd = t < Lc && k < P;
      cp_async16(&Cs[t * PD + k], okc ? Cm + (row0 + t) * N + k : Cm, okc);
      cp_async16(&Ds[t * PD + k],
                 okd ? dy + ((row0 + t) * H + h) * P + k : dy, okd);
    }
    const float* csc = cs + ((size_t(b) * nc + c) * H + h) * L;
    for (int e = tid; e < L / 4; e += THREADS)
      cp_async16(&cv[e * 4], csc + e * 4, true);
  };
  float carry[4][4];  // g[p0 + q][n0 + u] as carry[u][q]
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      carry[u][q] = dfinal && n0 + u < N && p0 + q < P
                        ? dfinal[bh * P * N + size_t(p0 + q) * N + n0 + u]
                        : 0.f;
  issue(nc - 1);
  cp_async_commit();
  for (int c = nc - 1; c >= 0; --c) {
    if (c > 0) {
      issue(c - 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* Cs = smem + (c & 1) * STATES_SLOT;
    float* Ds = Cs + L * PD;
    float* cv = Ds + L * PD;
    float* es = cv + L;
    if (tid < L) es[tid] = expf(cv[tid]);
    __syncthreads();
    float loc[4][4] = {};
    const int Lc = min(L, l - c * L);
#pragma unroll 4
    for (int i = 0; i < Lc; ++i) {  // missing steps are zero
      const float4 cr = ld4(&Cs[i * PD + n0]);
      float4 dv = ld4(&Ds[i * PD + p0]);
      const float e = es[i];
      dv.x *= e, dv.y *= e, dv.z *= e, dv.w *= e;
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          loc[u][q] = fmaf(get(cr, u), get(dv, q), loc[u][q]);
    }
    const float dec = es[L - 1];
    if (n0 < N && p0 < P) {
      float* out = g + ((size_t(b) * nc + c) * H + h) * size_t(N) * P;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (n0 + u < N)
          st4(&out[size_t(n0 + u) * P + p0],
              make_float4(carry[u][0], carry[u][1], carry[u][2],
                          carry[u][3]));
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        carry[u][q] = fmaf(carry[u][q], dec, loc[u][q]);
    __syncthreads();  // the slot is read before the next chunk's load
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n0 + u < N && p0 + q < P)
        dinit[bh * P * N + size_t(p0 + q) * N + n0 + u] = carry[u][q];
}

// ---- pass 3: each chunk and group of heads -----------------------------

// Thread roles.  The pairs: thread (ty, tx) = (tid / 16, tid % 16) holds
// (i, j) = (ty + 16 r, tx + 16 q), q <= r, of every (128 x 128) matrix, as
// the forward's C B^T scratch is laid out.  The tiles: of every (128 x 64)
// product, thread (a, c) = (tid / 16, tid % 16) holds columns 4 c .. + 4 of
// rows 4 a .. + 4 (r < 4) and 124 - 4 a .. + 4 (r >= 4).
__device__ __forceinline__ int tile_row(int a, int r) {
  return r < 4 ? 4 * a + r : 124 - 4 * a + (r - 4);
}

// Where element (row, k) of a (64 x 64) state tile lies: pitch PD, its
// 16-byte pieces rotated by row / 4, so that the 16 rows 4 c + u that a
// half-warp reads at once fall on distinct banks
__device__ __forceinline__ int st_at(int row, int k) {
  return row * PD + ((((k >> 2) ^ (row >> 2)) & 7) | ((k >> 2) & 8)) * 4 +
         (k & 3);
}

// acc[r][u] += sum over k < K of A[row r][k] Bt[col u][k], k in order: A a
// tile at pitch PD, Bt a state tile (st_at)
__device__ __forceinline__ void dot_tile(float (&acc)[8][4], const float* A,
                                         const float* Bt, int a, int col0,
                                         int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[8], bv[4];
#pragma unroll
    for (int r = 0; r < 8; ++r) av[r] = ld4(&A[tile_row(a, r) * PD + k]);
#pragma unroll
    for (int u = 0; u < 4; ++u) bv[u] = ld4(&Bt[st_at(col0 + u, k)]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[r][u] = dot4(av[r], bv[u], acc[r][u]);
  }
}

// The (128 x 128) matrices are kept packed by blocks of 16 rows.  Lower
// (G, ds): block ib keeps the columns j < 16 (ib + 1) at a pitch of 16 (ib
// + 1) + 4.  Upper (ds^T): block jb keeps the columns i >= 16 jb at a pitch
// of 132 - 16 jb.  Every entry a tile reads lies in a kept block; entries
// above (below) the diagonal inside a kept block are stored as zero.
__device__ __forceinline__ int lo_at(int i, int j) {
  const int ib = i >> 4;
  return 16 * (8 * ib * (ib + 1) + 4 * ib) + (i & 15) * (16 * ib + 20) + j;
}
__device__ __forceinline__ int up_at(int j, int i) {
  const int jb = j >> 4;
  return 16 * (132 * jb - 8 * jb * (jb - 1)) + (j & 15) * (132 - 16 * jb) +
         i - 16 * jb;
}
constexpr int TRI_FLOATS = 16 * (8 * 8 * 9 + 4 * 8);  // either layout

// shared memory of ssd_bwd_chunk, in floats: B, C, x, dy [L][PD] each;
// two regions of a packed (128 x 128) triangle each (the first also holds
// prev^T and dS^T [MAX_DIM][PD] each, the second dS); cs of two heads
// [2][L]; e^cs, w, dcs, C.(dy prev), B.(x dS) and M's row sums [L] each;
// M's column parts [16][L]; a reduction buffer [THREADS]
static_assert(2 * MAX_DIM * PD <= TRI_FLOATS, "the states fit a triangle");
constexpr size_t chunk_smem_floats() {
  return 4 * size_t(L) * PD + 2 * size_t(TRI_FLOATS) + 8 * L + 16 * L +
         THREADS;
}

// Two products over one walk: x[r][u] += sum over i >= row r, i < Lc of
// G[i][row r] dy[i][col0 + u], and y[r][u] likewise of S[i][row r]
// C[i][col0 + u] (G and S lower, lo_at), i in order: the low run from its
// first row, the high run joining at its own.  Rows are walked by block:
// the pitch is fixed within one.
__device__ __forceinline__ void lower_tiles(float (&x)[8][4], float (&y)[8][4],
                                            const float* G, const float* S,
                                            const float* dy, const float* C,
                                            int a, int col0, int Lc) {
  const int lo = 4 * a, hi = 124 - 4 * a;
  const int dh = hi - lo;
  for (int i0 = lo; i0 < Lc; i0 = (i0 | 15) + 1) {
    const int i1 = min((i0 | 15) + 1, Lc);   // this block's rows i0 .. i1
    const int pitch = 16 * (i0 >> 4) + 20;
    const int at = lo_at(i0, lo);
    const float* gl = G + at;
    const float* sl = S + at;
    const float* dv = dy + i0 * PD + col0;
    const float* cv = C + i0 * PD + col0;
    int i = i0;
    const int mid = min(i1, max(hi, i0));  // the low run alone below hi
#pragma unroll 2
    for (; i < mid; ++i, gl += pitch, sl += pitch, dv += PD, cv += PD) {
      const float4 g = ld4(gl), t = ld4(sl), d = ld4(dv), c = ld4(cv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[r][u] = fmaf(get(g, r), get(d, u), x[r][u]);
          y[r][u] = fmaf(get(t, r), get(c, u), y[r][u]);
        }
    }
#pragma unroll 2
    for (; i < i1; ++i, gl += pitch, sl += pitch, dv += PD, cv += PD) {
      const float4 g = ld4(gl), gh = ld4(gl + dh), t = ld4(sl),
                   th = ld4(sl + dh), d = ld4(dv), c = ld4(cv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[r][u] = fmaf(get(g, r), get(d, u), x[r][u]);
          x[r + 4][u] = fmaf(get(gh, r), get(d, u), x[r + 4][u]);
          y[r][u] = fmaf(get(t, r), get(c, u), y[r][u]);
          y[r + 4][u] = fmaf(get(th, r), get(c, u), y[r + 4][u]);
        }
    }
  }
}

// acc[r][u] += sum over j <= row r, j < Lc of Tt[j][row r] Op[j][col0 + u]
// (Tt upper, up_at), j in order: both runs up to the low run's last row,
// then the high run alone; walked by block as lower_tile
__device__ __forceinline__ void upper_tile(float (&acc)[8][4], const float* Tt,
                                           const float* Op, int a, int col0,
                                           int Lc) {
  const int lo = 4 * a, hi = 124 - 4 * a;
  const int both = min(lo + 4, Lc), end = min(hi + 4, Lc);
  const int dh = hi - lo;
  for (int j0 = 0; j0 < end; j0 += 16) {
    const int j1 = min(j0 + 16, end);
    const int pitch = 132 - 16 * (j0 >> 4);
    int j = j0;
    const float* op = Op + j0 * PD + col0;
    if (j < both) {
      const float* tl = Tt + up_at(j0, lo);
      const int jb = min(j1, both);
#pragma unroll 4
      for (; j < jb; ++j, tl += pitch, op += PD) {
        const float4 t = ld4(tl), th = ld4(tl + dh), ov = ld4(op);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[r][u] = fmaf(get(t, r), get(ov, u), acc[r][u]);
            acc[r + 4][u] = fmaf(get(th, r), get(ov, u), acc[r + 4][u]);
          }
      }
    }
    const float* th = Tt + up_at(j, hi);
#pragma unroll 4
    for (; j < j1; ++j, th += pitch, op += PD) {
      const float4 t = ld4(th), ov = ld4(op);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[r + 4][u] = fmaf(get(t, r), get(ov, u), acc[r + 4][u]);
    }
  }
}

// The 16 lanes of a half-warp (tid / 16 alike) sum each of v[0 .. 8) in a
// fixed order, the eight sums side by side; every lane gets them
__device__ __forceinline__ void half_warp_sums(float (&v)[8]) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1)
#pragma unroll
    for (int r = 0; r < 8; ++r) v[r] += __shfl_xor_sync(0xffffffffu, v[r], o);
}

// One warp: dcs[L - 1] += sum_j w_j B_j . (x dS)_j + exp(total) sum(dS
// prev) (red: THREADS partials of the last sum), then da = the reverse
// cumulative sum of dcs within the chunk, rows below Lc stored (da_h: the
// chunk's first row of da for this head, rows H apart).  Lane k holds steps
// 4 k .. + 4; every sum runs in a fixed order.
__device__ __forceinline__ void chunk_da(const float* dcs, const float* wv,
                                         const float* bvv, const float* red,
                                         float total, float* da_h, int H,
                                         int Lc, int lane) {
  float sdp = 0.f, sw = 0.f, v[4];
#pragma unroll
  for (int t = 0; t < THREADS / 32; ++t) sdp += red[lane * (THREADS / 32) + t];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    sw = fmaf(wv[4 * lane + t], bvv[4 * lane + t], sw);
    v[t] = dcs[4 * lane + t];
  }
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) {
    sdp += __shfl_xor_sync(0xffffffffu, sdp, o);
    sw += __shfl_xor_sync(0xffffffffu, sw, o);
  }
  if (lane == 31) v[3] += fmaf(expf(total), sdp, sw);
  v[2] += v[3];
  v[1] += v[2];
  v[0] += v[1];
  // the sum of every later lane's steps: a suffix scan over the lanes
  float incl = v[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += nb;
  }
  float later = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) later = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = 4 * lane + t;
    if (i < Lc) da_h[size_t(i) * H] = v[t] + later;
  }
}

// prev^T and dS^T of one head (S^T, as stored) into state tiles laid out
// by st_at, by cp.async (no commit); zero past P and N
__device__ void issue_states(float* Pt, float* St, const float* pg,
                             const float* sg, int P, int N) {
  for (int e = threadIdx.x; e < MAX_DIM * (MAX_DIM / 4); e += THREADS) {
    const int n = e / (MAX_DIM / 4), p = (e % (MAX_DIM / 4)) * 4;
    const bool ok = n < N && p < P;
    cp_async16(&Pt[st_at(n, p)], ok ? pg + n * P + p : pg, ok);
    cp_async16(&St[st_at(n, p)], ok ? sg + n * P + p : sg, ok);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ prev, const float* __restrict__ cs,
              const float* __restrict__ cbs, const float* __restrict__ dS,
              float* __restrict__ dx, float* __restrict__ da,
              float* __restrict__ dBo, float* __restrict__ dCo, int l, int H,
              int P, int N, int heads) {
  extern __shared__ float4 smem4[];
  float* Bs = reinterpret_cast<float*>(smem4);  // [L][PD] B
  float* Cs = Bs + L * PD;                      // [L][PD] C
  float* Xs = Cs + L * PD;                      // [L][PD] x
  float* Ds = Xs + L * PD;                      // [L][PD] dy
  float* R1 = Ds + L * PD;                      // prev^T, dS^T; then ds
  float* R2 = R1 + TRI_FLOATS;                  // dS; then G, then ds^T
  float* csb = R2 + TRI_FLOATS;                 // [2][L] cs, by head parity
  float* ecs = csb + 2 * L;                     // [L] exp(cs)
  float* wv = ecs + L;                          // [L] exp(total - cs)
  float* dcs = wv + L;                          // [L] d cs
  float* cu = dcs + L;                          // [L] C_i . (dy prev)_i
  float* bvv = cu + L;                          // [L] B_j . (x dS)_j
  float* rowm = bvv + L;                        // [L] M's row sums
  float* colred = rowm + L;                     // [16][L] M's column parts
  float* red = colred + 16 * L;                 // [THREADS]
  float* Pt = R1;                  // prev^T [n][p], st_at
  float* St = R1 + MAX_DIM * PD;   // dS^T [n][p], st_at
  float* Sp = R2;                  // dS [p][n], st_at

  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  const int grp = blockIdx.y, groups = gridDim.y;
  const int h0 = grp * heads, nh = min(heads, H - h0);
  const int c0 = c * L, Lc = min(L, l - c0);
  const int tid = threadIdx.x;
  const size_t row0 = size_t(b) * l + c0;
  const size_t PN = size_t(P) * N;
  const int ty = tid / 16, tx = tid % 16;  // pairs; also tiles (a, cg)
  const int col0 = tx * 4;
  const size_t bc = size_t(b) * nc + c;
  // head h's cs into its parity's buffer; its states (no commit)
  auto issue_cs = [&](int h) {
    if (tid < L / 4)
      cp_async16(&csb[(h & 1) * L + tid * 4], cs + (bc * H + h) * L + tid * 4,
                 true);
  };
  auto issue_st = [&](int h) {
    issue_states(Pt, St, prev + (bc * H + h) * PN, dS + (bc * H + h) * PN,
                 P, N);
  };

  issue_rows(Bs, Bm, row0, Lc, 1, 0, N);
  issue_rows(Cs, Cm, row0, Lc, 1, 0, N);
  issue_rows(Xs, x, row0, Lc, H, h0, P);
  issue_rows(Ds, dy, row0, Lc, H, h0, P);
  issue_cs(h0);
  issue_st(h0);
  cp_async_commit();

  float dBa[8][4], dCa[8][4];  // the group's dB (rows j), dC (rows i)
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) dBa[r][u] = dCa[r][u] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* csv = csb + (h & 1) * L;
    cp_async_wait_all();
    __syncthreads();  // x, dy, cs, the states arrived; the last head's
                      // ds^T and dcs are read
    // dS transposed, and sum(dS * prev) per thread in order
    {
      float s = 0.f;
      for (int e = tid; e < MAX_DIM * MAX_DIM; e += THREADS) {
        const int n = e / MAX_DIM, p = e % MAX_DIM;
        const float sv = St[st_at(n, p)];
        Sp[st_at(p, n)] = sv;
        s = fmaf(sv, Pt[st_at(n, p)], s);
      }
      red[tid] = s;
    }
    if (tid < L) {
      const float total = csv[L - 1];
      ecs[tid] = expf(csv[tid]);
      wv[tid] = expf(total - csv[tid]);
    }
    __syncthreads();  // dS, ecs, wv and red are written
    const float total = csv[L - 1];

    // U = dy prev (rows i): dC += e^cs U, C_i . U_i
    float dxa[8][4];
    {
      float U[8][4] = {}, s[8];
      dot_tile(U, Ds, Pt, ty, col0, P);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = tile_row(ty, r);
        const float e = ecs[i];
        const float4 cv = ld4(&Cs[i * PD + col0]);
        s[r] = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dCa[r][u] = fmaf(e, U[r][u], dCa[r][u]);
          s[r] = fmaf(get(cv, u), U[r][u], s[r]);
        }
      }
      half_warp_sums(s);
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) cu[tile_row(ty, r)] = s[r];
      }
    }
    // V = x dS (rows j): dB += w V, B_j . V_j
    {
      float V[8][4] = {}, s[8];
      dot_tile(V, Xs, St, ty, col0, P);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = tile_row(ty, r);
        const float w = wv[j];
        const float4 bv = ld4(&Bs[j * PD + col0]);
        s[r] = 0.f;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          dBa[r][u] = fmaf(w, V[r][u], dBa[r][u]);
          s[r] = fmaf(get(bv, u), V[r][u], s[r]);
        }
      }
      half_warp_sums(s);
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) bvv[tile_row(ty, r)] = s[r];
      }
    }
    // dx = w (B dS^T) (rows j), G^T dy added below
    {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int u = 0; u < 4; ++u) dxa[r][u] = 0.f;
      dot_tile(dxa, Bs, Sp, ty, col0, N);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float w = wv[tile_row(ty, r)];
#pragma unroll
        for (int u = 0; u < 4; ++u) dxa[r][u] *= w;
      }
    }

    // C B^T of the chunk, on this thread's pairs (the forward's scratch)
    float cb[8][8];
    {
      const float* in = cbs + bc * CB_FLOATS + tid;
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          cb[r][q] = q <= r ? in[(r * (r + 1) / 2 + q) * 256] : 0.f;
    }
    // dy x^T on this thread's pairs, k in order
    float dg[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) dg[r][q] = 0.f;
    for (int k = 0; k < P; k += 4) {
      float4 dv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) dv[r] = ld4(&Ds[(ty + 16 * r) * PD + k]);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 xv = ld4(&Xs[(tx + 16 * q) * PD + k]);
#pragma unroll
        for (int r = q; r < 8; ++r) dg[r][q] = dot4(dv[r], xv, dg[r][q]);
      }
    }
    __syncthreads();  // x and the states are read
    if (hh + 1 < nh) {
      issue_rows(Xs, x, row0, Lc, H, h + 1, P);
      issue_cs(h + 1);
      cp_async_commit();
    }

    // G = cb E (into cb), ds = dg E (into dg), M = ds cb: its row sums by
    // half-warp, its column parts to colred
    {
      float colp[8], rowp[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) colp[q] = 0.f;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        const float cs_i = csv[i];
        rowp[r] = 0.f;
#pragma unroll
        for (int q = 0; q <= r; ++q) {
          const int j = tx + 16 * q;
          // mask before exp: exp(cs_i - cs_j) may overflow for j > i
          const float e = j <= i ? expf(cs_i - csv[j]) : 0.f;
          const float ds = dg[r][q] * e;
          const float m = ds * cb[r][q];
          cb[r][q] *= e;
          dg[r][q] = ds;
          rowp[r] += m;
          colp[q] += m;
        }
      }
      half_warp_sums(rowp);
      if (tx == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) rowm[ty + 16 * r] = rowp[r];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) colred[ty * L + tx + 16 * q] = colp[q];
    }
    __syncthreads();
    if (tid < L) {  // dcs but for the last step's sums (chunk_da)
      float colm = 0.f;
      for (int t = 0; t < 16; ++t) colm += colred[t * L + tid];
      dcs[tid] = fmaf(ecs[tid], cu[tid], rowm[tid] - colm) -
                 wv[tid] * bvv[tid];
    }

    // G into R2, ds into R1; dx += G^T dy and dB += ds^T C (rows j)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) {
        const int at = lo_at(ty + 16 * r, tx + 16 * q);
        R2[at] = cb[r][q];
        R1[at] = dg[r][q];
      }
    __syncthreads();
    if (tid < 32)
      chunk_da(dcs, wv, bvv, red, total, da + row0 * H + h, H, Lc, tid);
    lower_tiles(dxa, dBa, R2, R1, Ds, Cs, ty, col0, Lc);
    if (col0 < P) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = tile_row(ty, r);
        if (j < Lc)
          st4(&dx[((row0 + j) * H + h) * P + col0],
              make_float4(dxa[r][0], dxa[r][1], dxa[r][2], dxa[r][3]));
      }
    }
    __syncthreads();  // G, ds and dy are read
    if (hh + 1 < nh) {
      issue_rows(Ds, dy, row0, Lc, H, h + 1, P);
      issue_st(h + 1);
      cp_async_commit();
    }
    // ds^T into R2; dC += ds B (rows i)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q)
        R2[up_at(tx + 16 * q, ty + 16 * r)] = dg[r][q];
    __syncthreads();
    upper_tile(dCa, R2, Bs, ty, col0, Lc);
  }
  // dB and dC of the group: to the outputs, or to the groups' scratch
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = tile_row(ty, r);
    if (i >= Lc || col0 >= N) continue;
    const size_t at = ((row0 + i) * groups + grp) * N + col0;
    st4(&dBo[at], make_float4(dBa[r][0], dBa[r][1], dBa[r][2], dBa[r][3]));
    st4(&dCo[at], make_float4(dCa[r][0], dCa[r][1], dCa[r][2], dCa[r][3]));
  }
}

// ---- pass 4: dB and dC over the groups ---------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_bwd_group_sum(const float* __restrict__ dbg, const float* __restrict__ dcg,
                  float* __restrict__ dB, float* __restrict__ dC, size_t rows,
                  int groups, int N) {
  const size_t e = size_t(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= rows * N) return;
  const size_t row = e / N;
  const int n = int(e % N);
  const float* pb = dbg + row * groups * N + n;
  const float* pc = dcg + row * groups * N + n;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < groups; ++g) {
    sb += pb[size_t(g) * N];
    sc += pc[size_t(g) * N];
  }
  dB[e] = sb;
  dC[e] = sc;
}

}  // namespace

// Plain C entry.  prev (batch, chunks, H, N, P), cs (batch, chunks, H, 128)
// and cbs (batch, chunks, 36 * 256) are the forward's scratch (ssd_scan.cu's
// first two passes); dfinal may be null (the final state unused).  g
// (batch, chunks, H, N, P), each chunk's state gradient, is f32 scratch
// from the caller, and so are dbg and dcg (batch, l, groups, N) for more
// than one group of `heads` heads (null for one: the chunk pass then
// writes dB and dC).  Three launches on stream, two for one group.  Returns the CUDA error code of the first
// launch that failed (0 = all launched), or cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* B, const void* C,
                                  const void* dy, const void* dfinal,
                                  const void* prev, const void* cs,
                                  const void* cbs, void* dx, void* da,
                                  void* dB, void* dC, void* dinit, void* g,
                                  void* dbg, void* dcg, int batch, int l,
                                  int H, int P, int N, int heads,
                                  void* stream) {
  if (P % 4 || P < 4 || P > MAX_DIM || N % 4 || N < 4 || N > MAX_DIM ||
      l < 1 || heads < 1 || heads > H)
    return int(cudaErrorInvalidValue);
  const int groups = (H + heads - 1) / heads;
  if (groups > 1 && (!dbg || !dcg)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (l + L - 1) / L;
  const float* csf = static_cast<const float*>(cs);
  float* gf = static_cast<float*>(g);

  const size_t smem1 = sizeof(float) * STATES_SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem1));
  if (err != cudaSuccess) return int(err);
  ssd_bwd_states<<<dim3(H, batch), THREADS, smem1, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(C), csf,
      static_cast<const float*>(dfinal), gf, static_cast<float*>(dinit), l,
      nc, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  float* dBo = static_cast<float*>(groups > 1 ? dbg : dB);
  float* dCo = static_cast<float*>(groups > 1 ? dcg : dC);
  const size_t smem3 = sizeof(float) * chunk_smem_floats();
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem3));
  if (err != cudaSuccess) return int(err);
  ssd_bwd_chunk<<<dim3(nc, groups, batch), THREADS, smem3, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(prev), csf, static_cast<const float*>(cbs),
      gf, static_cast<float*>(dx), static_cast<float*>(da), dBo, dCo, l, H, P,
      N, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess || groups == 1) return int(err);

  const size_t rows = size_t(batch) * l;
  const size_t blocks = (rows * N + THREADS - 1) / THREADS;
  ssd_bwd_group_sum<<<unsigned(blocks), THREADS, 0, s>>>(
      static_cast<const float*>(dbg), static_cast<const float*>(dcg),
      static_cast<float*>(dB), static_cast<float*>(dC), rows, groups, N);
  return int(cudaGetLastError());
}
