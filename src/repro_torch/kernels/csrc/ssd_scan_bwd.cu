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
// Layouts are the forward's (ssd_scan.cu); all f32, contiguous, 16-byte
// aligned; p and n multiples of 4, at most 64.  A ragged last chunk reads
// its missing steps as x = dy = B = C = 0; its cs there is the forward's
// (a = 0, so cs stays at its last real value).
//
// What bounds it on an H100: at zamba2-7b's largest prefill bucket (b = 1,
// l = 1024, h = 112, p = n = 64) the gradients need ~8.5 GFLOP (C B^T once
// per chunk; per head and chunk the lower triangles of dy x^T, G^T dy, ds B
// and ds^T C, and five (128 x 64 x 64) products: the chunk's own state
// again, loc, dy prev, x dS and B dS^T), ~0.13 ms at the 67 TFLOP/s f32
// rate, against ~96 MB of inputs and outputs (~0.03 ms at 3.35 TB/s):
// bound by operations.  All products are IEEE f32 FMAs.
//
// What this design does about it: the first version is plain and
// parallel over every chunk and head.  It takes the state before each
// chunk and cs from the forward's first two passes (the wrapper runs them
// again, so training keeps no scan scratch between forward and backward),
// then four launches on the caller's stream, every kernel named "ssd_":
// 1. ssd_bwd_local, one CTA per (chunk, head, batch): loc^T (n, p).
// 2. ssd_bwd_state_pass, one CTA per (elements of S^T, head, batch): the
//    recurrence in reverse chunk order; dS_c overwrites loc_c in place.
// 3. ssd_bwd_chunk, one CTA per (chunk, head, batch), 208 KB of shared
//    memory: x, dy, B, C of the chunk, and one 128 x 128 tile T that holds
//    in turn M (its row and column sums give dcs), G (for dx) and ds (for
//    dB and dC), then prev and dS.  Each thread holds the same 8 strided
//    rows (i = ty + 16 r) of every (128 x 128) and (128 x 64) tile, so a
//    row's partial sums meet in one half-warp's shuffles; sums over the
//    chunk are sequential in shared memory, so results do not depend on
//    scheduling.  It writes dx, da and each head's dB and dC.
// 4. ssd_bwd_head_sum: dB and dC summed over the heads in order.
// Not done yet: C B^T once per chunk rather than per head, tensor cores,
// and fusing passes 1-2 into the forward's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;        // steps per chunk
constexpr int THREADS = 256;
constexpr int MAX_DIM = 64;   // p and n
constexpr int PD = MAX_DIM + 4;  // pitch of a (128 x 64) tile in shared
constexpr int TP = L + 1;     // pitch of the (128 x 128) tile

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float get(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// rows of one chunk of a (b, l, H, K) tensor (head h) or a (b, l, K) one
// (H = 1, h = 0) into a [L][PD] shared tile: columns past K and rows past
// Lc are zero
__device__ void load_rows(float* dst, const float* src, size_t row0, int Lc,
                          int H, int h, int K) {
  for (int e = threadIdx.x; e < L * (MAX_DIM / 4); e += THREADS) {
    const int t = e / (MAX_DIM / 4), k = (e % (MAX_DIM / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < Lc && k < K) v = ld4(src + ((row0 + t) * H + h) * K + k);
    *reinterpret_cast<float4*>(&dst[t * PD + k]) = v;
  }
}

// ---- pass 1: each chunk's own gradient of the state before it ----------

// loc^T[n][p] = sum_i exp(cs_i) C[i][n] dy[i][p], one CTA per (chunk, head,
// batch), thread (n0 .. + 4, p0 .. + 4), 32 steps of the chunk at a time
constexpr int LOC_ROWS = 32;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_local(const float* __restrict__ dy, const float* __restrict__ Cm,
              const float* __restrict__ cs, float* __restrict__ g, int l,
              int H, int P, int N) {
  __shared__ __align__(16) float Ds[LOC_ROWS * PD];
  __shared__ __align__(16) float Cs[LOC_ROWS * PD];
  __shared__ float es[L];
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * L, Lc = min(L, l - c0);
  const int tid = threadIdx.x;
  const size_t bch = (size_t(b) * nc + c) * H + h;
  for (int i = tid; i < L; i += THREADS) es[i] = expf(cs[bch * L + i]);
  const int p0 = (tid % 16) * 4, n0 = (tid / 16) * 4;
  float acc[4][4] = {};
  for (int t0 = 0; t0 < Lc; t0 += LOC_ROWS) {
    __syncthreads();  // es is written, or the last tile is read
    for (int e = tid; e < LOC_ROWS * (MAX_DIM / 4); e += THREADS) {
      const int t = e / (MAX_DIM / 4), k = (e % (MAX_DIM / 4)) * 4;
      const int i = t0 + t;
      float4 dv = make_float4(0.f, 0.f, 0.f, 0.f), cv = dv;
      if (i < Lc && k < P) {
        dv = ld4(dy + ((size_t(b) * l + c0 + i) * H + h) * P + k);
        const float e_i = es[i];
        dv.x *= e_i, dv.y *= e_i, dv.z *= e_i, dv.w *= e_i;
      }
      if (i < Lc && k < N) cv = ld4(Cm + (size_t(b) * l + c0 + i) * N + k);
      *reinterpret_cast<float4*>(&Ds[t * PD + k]) = dv;
      *reinterpret_cast<float4*>(&Cs[t * PD + k]) = cv;
    }
    __syncthreads();
    for (int t = 0; t < LOC_ROWS; ++t) {
      const float4 dv = ld4(&Ds[t * PD + p0]);
      const float4 cv = ld4(&Cs[t * PD + n0]);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int pi = 0; pi < 4; ++pi)
          acc[ni][pi] = fmaf(get(cv, ni), get(dv, pi), acc[ni][pi]);
    }
  }
  if (p0 >= P || n0 >= N) return;
  float* out = g + bch * size_t(N) * P;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
    *reinterpret_cast<float4*>(&out[size_t(n0 + ni) * P + p0]) =
        make_float4(acc[ni][0], acc[ni][1], acc[ni][2], acc[ni][3]);
}

// ---- pass 2: the recurrence across chunks, in reverse ------------------

// element e = n * P + p of S^T for one (batch, head): from g = dfinal (or
// 0), for c = nc - 1 .. 0: dS_c = g overwrites loc_c, g = loc_c + g
// exp(total_c); dinit (b, h, p, n) = g
__global__ void __launch_bounds__(THREADS)
ssd_bwd_state_pass(float* __restrict__ g, const float* __restrict__ cs,
                   const float* __restrict__ dfinal, float* __restrict__ dinit,
                   int nc, int H, int P, int N) {
  const int e = blockIdx.x * THREADS + threadIdx.x, h = blockIdx.y;
  const int b = blockIdx.z;
  const int PN = P * N;
  if (e >= PN) return;
  const int p = e % P, n = e / P;
  const size_t bh = size_t(b) * H + h;
  float carry = dfinal ? dfinal[bh * PN + size_t(p) * N + n] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bch = (size_t(b) * nc + c) * H + h;
    float* gp = g + bch * PN + e;
    const float loc = *gp;
    *gp = carry;
    carry = fmaf(carry, expf(cs[bch * L + L - 1]), loc);
  }
  dinit[bh * PN + size_t(p) * N + n] = carry;
}

// ---- pass 3: each chunk and head ---------------------------------------

// shared memory, in floats: x, dy, B, C [L][PD] each; T [L][TP]; cs, e^cs,
// w, dcs and w B.(x dS) [L] each; a reduction buffer [THREADS]
constexpr size_t CHUNK_SMEM_FLOATS =
    4 * size_t(L) * PD + size_t(L) * TP + 5 * L + THREADS;

// the 16 lanes of a half-warp that share a thread's rows (tid / 16) sum v;
// every one of them gets the sum
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ prev, const float* __restrict__ cs,
              const float* __restrict__ dS, float* __restrict__ dx,
              float* __restrict__ da, float* __restrict__ dbh,
              float* __restrict__ dch, int l, int H, int P, int N) {
  extern __shared__ float4 smem4[];
  float* Xs = reinterpret_cast<float*>(smem4);  // [L][PD] x
  float* Ds = Xs + L * PD;                      // [L][PD] dy
  float* Bs = Ds + L * PD;                      // [L][PD] B
  float* Cs = Bs + L * PD;                      // [L][PD] C
  float* T = Cs + L * PD;                       // [L][TP]
  float* csv = T + L * TP;                      // [L] cs
  float* ecs = csv + L;                         // [L] exp(cs)
  float* wv = ecs + L;                          // [L] exp(total - cs)
  float* dcs = wv + L;                          // [L] d cs
  float* wdw = dcs + L;                         // [L] w_j B_j . (x dS)_j
  float* red = wdw + L;                         // [THREADS]
  // after the (128 x 128) products, T holds prev [p][n], dS [p][n] and
  // dS^T [n][p], each [MAX_DIM][PD]
  float* Pm = T;
  float* Sm = T + MAX_DIM * PD;
  float* St = Sm + MAX_DIM * PD;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * L, Lc = min(L, l - c0);
  const int tid = threadIdx.x;
  const size_t row0 = size_t(b) * l + c0;
  const size_t bch = (size_t(b) * nc + c) * H + h;
  const int PN = P * N;

  load_rows(Xs, x, row0, Lc, H, h, P);
  load_rows(Ds, dy, row0, Lc, H, h, P);
  load_rows(Bs, Bm, row0, Lc, 1, 0, N);
  load_rows(Cs, Cm, row0, Lc, 1, 0, N);
  for (int i = tid; i < L; i += THREADS) csv[i] = cs[bch * L + i];
  __syncthreads();
  const float total = csv[L - 1];
  for (int i = tid; i < L; i += THREADS) {
    ecs[i] = expf(csv[i]);
    wv[i] = expf(total - csv[i]);
  }

  // this thread's rows ty + 16 r of every tile; of a (128 x 128) tile the
  // columns tx + 16 q, q <= r (the rest is zero: j > i), of a (128 x 64)
  // tile the columns k0 .. k0 + 4
  const int ty = tid / 16, tx = tid % 16;
  const int k0 = tx * 4;

  // C B^T and dy x^T on this thread's pairs (i, j), k in order
  float cb[8][8], dg[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q) cb[r][q] = dg[r][q] = 0.f;
  for (int k = 0; k < MAX_DIM; k += 4) {
    float4 cv[8], bv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      cv[r] = ld4(&Cs[(ty + 16 * r) * PD + k]);
      bv[r] = ld4(&Bs[(tx + 16 * r) * PD + k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) cb[r][q] = dot4(cv[r], bv[q], cb[r][q]);
  }
  for (int k = 0; k < MAX_DIM; k += 4) {
    float4 dv[8], xv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      dv[r] = ld4(&Ds[(ty + 16 * r) * PD + k]);
      xv[r] = ld4(&Xs[(tx + 16 * r) * PD + k]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) dg[r][q] = dot4(dv[r], xv[q], dg[r][q]);
  }
  __syncthreads();  // ecs and wv are written
  // G = cb E (into cb), ds = dg E (into dg), M = ds cb into T
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    const float cs_i = csv[i];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = tx + 16 * q;
      float m = 0.f;
      if (q <= r) {
        // mask before exp: exp(cs_i - cs_j) may overflow for j > i
        const float e = j <= i ? expf(cs_i - csv[j]) : 0.f;
        const float gg = cb[r][q] * e, ds = dg[r][q] * e;
        m = ds * cb[r][q];
        cb[r][q] = gg;
        dg[r][q] = ds;
      }
      T[i * TP + j] = m;
    }
  }
  __syncthreads();
  // dcs = row sums - column sums of M, each in order
  if (tid < L) {
    float s = 0.f;
    for (int j = 0; j < L; ++j) s += T[tid * TP + j];
    red[tid] = s;
  } else {
    const int j = tid - L;
    float s = 0.f;
    for (int i = 0; i < L; ++i) s += T[i * TP + j];
    dcs[j] = -s;
  }
  __syncthreads();
  if (tid < L) dcs[tid] += red[tid];
  // T = G; dx = G^T dy on rows j = ty + 16 r, columns k0 ..
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      T[(ty + 16 * r) * TP + tx + 16 * q] = q <= r ? cb[r][q] : 0.f;
  __syncthreads();
  float dxa[8][4], dca[8][4], dba[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) dxa[r][u] = dca[r][u] = dba[r][u] = 0.f;
  for (int i = ty; i < Lc; ++i) {  // G[i][j] = 0 for i < j
    const float4 dv = ld4(&Ds[i * PD + k0]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float gv = T[i * TP + ty + 16 * r];
#pragma unroll
      for (int u = 0; u < 4; ++u) dxa[r][u] = fmaf(gv, get(dv, u), dxa[r][u]);
    }
  }
  __syncthreads();
  // T = ds; dC_h = ds B on rows i, dB_h = ds^T C on rows j
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 8; ++q)
      T[(ty + 16 * r) * TP + tx + 16 * q] = q <= r ? dg[r][q] : 0.f;
  __syncthreads();
  const int jmax = min(Lc, ty + 16 * 7 + 1);  // ds[i][j] = 0 for j > i
  for (int j = 0; j < jmax; ++j) {
    const float4 bv = ld4(&Bs[j * PD + k0]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float sv = T[(ty + 16 * r) * TP + j];
#pragma unroll
      for (int u = 0; u < 4; ++u) dca[r][u] = fmaf(sv, get(bv, u), dca[r][u]);
    }
  }
  for (int i = ty; i < Lc; ++i) {
    const float4 cv = ld4(&Cs[i * PD + k0]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float sv = T[i * TP + ty + 16 * r];
#pragma unroll
      for (int u = 0; u < 4; ++u) dba[r][u] = fmaf(sv, get(cv, u), dba[r][u]);
    }
  }
  __syncthreads();
  // T = prev [p][n], dS [p][n], dS^T [n][p] (zero past P and N)
  {
    const float* pg = prev + bch * size_t(PN);
    const float* sg = dS + bch * size_t(PN);
    for (int e = tid; e < MAX_DIM * MAX_DIM; e += THREADS) {
      const int n = e / MAX_DIM, p = e % MAX_DIM;
      const bool ok = n < N && p < P;
      const float pv = ok ? pg[n * P + p] : 0.f;
      const float sv = ok ? sg[n * P + p] : 0.f;
      Pm[p * PD + n] = pv;
      Sm[p * PD + n] = sv;
      St[n * PD + p] = sv;
    }
  }
  __syncthreads();
  // U = dy prev, V = x dS on rows ty + 16 r, columns k0 .. (n); dx += w B
  // dS^T on columns k0 .. (p)
  float U[8][4], V[8][4], W[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) U[r][u] = V[r][u] = W[r][u] = 0.f;
  for (int k = 0; k < MAX_DIM; ++k) {
    const float4 pv = ld4(&Pm[k * PD + k0]);  // prev[k][n0 ..]
    const float4 sv = ld4(&Sm[k * PD + k0]);  // dS[k][n0 ..]
    const float4 tv = ld4(&St[k * PD + k0]);  // dS[p0 ..][k]
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
      const float dv = Ds[i * PD + k], xv = Xs[i * PD + k];
      const float bv = Bs[i * PD + k];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        U[r][u] = fmaf(dv, get(pv, u), U[r][u]);
        V[r][u] = fmaf(xv, get(sv, u), V[r][u]);
        W[r][u] = fmaf(bv, get(tv, u), W[r][u]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    const float e_i = ecs[i], w_i = wv[i];
    const float4 cv = ld4(&Cs[i * PD + k0]);
    const float4 bv = ld4(&Bs[i * PD + k0]);
    float cu = 0.f, bw = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      dca[r][u] = fmaf(e_i, U[r][u], dca[r][u]);
      dba[r][u] = fmaf(w_i, V[r][u], dba[r][u]);
      dxa[r][u] = fmaf(w_i, W[r][u], dxa[r][u]);
      cu = fmaf(get(cv, u), U[r][u], cu);
      bw = fmaf(get(bv, u), V[r][u], bw);
    }
    cu = half_warp_sum(cu);
    bw = half_warp_sum(bw);
    if (tx == 0) {
      dcs[i] += e_i * cu - w_i * bw;
      wdw[i] = w_i * bw;
    }
  }
  // sum(dS * prev), over this thread's elements then over the threads
  {
    float s = 0.f;
    for (int e = tid; e < MAX_DIM * MAX_DIM; e += THREADS) {
      const int p = e / MAX_DIM, n = e % MAX_DIM;
      s = fmaf(Sm[p * PD + n], Pm[p * PD + n], s);
    }
    red[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f, sw = 0.f;
    for (int t = 0; t < THREADS; ++t) s += red[t];
    for (int j = 0; j < L; ++j) sw += wdw[j];
    dcs[L - 1] += sw + expf(total) * s;
    // da: dcs summed from each step to the chunk's end
    float run = 0.f;
    for (int i = L - 1; i >= 0; --i) {
      run += dcs[i];
      if (i < Lc) da[(row0 + i) * H + h] = run;
    }
  }
  if (k0 >= P && k0 >= N) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = ty + 16 * r;
    if (i >= Lc) continue;
    if (k0 < P)
      *reinterpret_cast<float4*>(&dx[((row0 + i) * H + h) * P + k0]) =
          make_float4(dxa[r][0], dxa[r][1], dxa[r][2], dxa[r][3]);
    if (k0 < N) {
      const size_t at = ((row0 + i) * H + h) * N + k0;
      *reinterpret_cast<float4*>(&dch[at]) =
          make_float4(dca[r][0], dca[r][1], dca[r][2], dca[r][3]);
      *reinterpret_cast<float4*>(&dbh[at]) =
          make_float4(dba[r][0], dba[r][1], dba[r][2], dba[r][3]);
    }
  }
}

// ---- pass 4: dB and dC over the heads ----------------------------------

__global__ void __launch_bounds__(THREADS)
ssd_bwd_head_sum(const float* __restrict__ dbh, const float* __restrict__ dch,
                 float* __restrict__ dB, float* __restrict__ dC, size_t rows,
                 int H, int N) {
  const size_t e = size_t(blockIdx.x) * THREADS + threadIdx.x;
  if (e >= rows * N) return;
  const size_t row = e / N;
  const int n = int(e % N);
  const float* pb = dbh + row * H * N + n;
  const float* pc = dch + row * H * N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[size_t(h) * N];
    sc += pc[size_t(h) * N];
  }
  dB[e] = sb;
  dC[e] = sc;
}

}  // namespace

// Plain C entry.  prev (batch, chunks, H, N, P) and cs (batch, chunks, H,
// 128) are the forward's first two passes' scratch (ssd_scan.cu with y
// null); dfinal may be null (the final state unused).  g (batch, chunks, H,
// N, P), dbh and dch (batch, l, H, N) are f32 scratch from the caller.
// Four launches on stream.  Returns the CUDA error code of the first launch
// that failed (0 = all launched), or cudaErrorInvalidValue for what the
// kernels do not take.
extern "C" int repro_ssd_scan_bwd(const void* x, const void* B, const void* C,
                                  const void* dy, const void* dfinal,
                                  const void* prev, const void* cs, void* dx,
                                  void* da, void* dB, void* dC, void* dinit,
                                  void* g, void* dbh, void* dch, int batch,
                                  int l, int H, int P, int N, void* stream) {
  if (P % 4 || P < 4 || P > MAX_DIM || N % 4 || N < 4 || N > MAX_DIM ||
      l < 1)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (l + L - 1) / L;
  const float* csf = static_cast<const float*>(cs);
  float* gf = static_cast<float*>(g);
  float* dbhf = static_cast<float*>(dbh);
  float* dchf = static_cast<float*>(dch);

  ssd_bwd_local<<<dim3(nc, H, batch), THREADS, 0, s>>>(
      static_cast<const float*>(dy), static_cast<const float*>(C), csf, gf, l,
      H, P, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  ssd_bwd_state_pass<<<dim3((P * N + THREADS - 1) / THREADS, H, batch),
                       THREADS, 0, s>>>(gf, csf,
                                        static_cast<const float*>(dfinal),
                                        static_cast<float*>(dinit), nc, H, P,
                                        N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t smem = sizeof(float) * CHUNK_SMEM_FLOATS;
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err != cudaSuccess) return int(err);
  ssd_bwd_chunk<<<dim3(nc, H, batch), THREADS, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(dy),
      static_cast<const float*>(prev), csf, gf, static_cast<float*>(dx),
      static_cast<float*>(da), dbhf, dchf, l, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  const size_t rows = size_t(batch) * l;
  const size_t blocks = (rows * N + THREADS - 1) / THREADS;
  ssd_bwd_head_sum<<<unsigned(blocks), THREADS, 0, s>>>(
      dbhf, dchf, static_cast<float*>(dB), static_cast<float*>(dC), rows, H,
      N);
  return int(cudaGetLastError());
}
