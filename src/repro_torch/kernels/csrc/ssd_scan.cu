// Mamba2 SSD chunk scan for NVIDIA Hopper (sm_90a): the prefill kernel of
// the hybrid family's Mamba2 layers.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan_kernel / _ssd_kernel
// (Pallas, TPU).  Same function, over chunks of 128 steps with the state
// S (p x n) carried across chunks in f32, per (batch, head):
//   cs     = cumsum(a) within the chunk, total = cs[last]
//   G[i,j] = (C_i . B_j) exp(cs_i - cs_j) for j <= i, else 0
//   y      = G x + exp(cs) (C S^T)
//   S'     = exp(total) S + x^T (B exp(total - cs))
// Beyond the TPU kernel, it starts from an initial state (or zeros) and
// returns the final state, which prefill-with-state needs.  Layouts are the
// model's own: x/y (b, l, h, p), a (b, l, h), B/C (b, l, n) shared by all
// heads (read by batch, never copied per head), init/final (b, h, p, n); all
// f32, contiguous and 16-byte aligned; p and n multiples of 4, at most 64.
// A ragged last chunk is predicated: its missing steps read as a = 0,
// x = B = C = 0, so they leave the state unchanged, and their y rows are
// not stored.
//
// What bounds it on an H100: at zamba2-7b's largest prefill bucket (b = 1,
// l = 1024, h = 112, p = n = 64) the function needs ~2.8 GFLOP (C B^T once
// per batch and chunk, G x, C S^T and x^T B per head, lower triangles only),
// ~42 us at the 67 TFLOP/s f32 rate, against ~63 MB of inputs and outputs
// (~19 us at 3.35 TB/s): bound by operations.  All products are IEEE f32
// FMAs (no TF32), as the f32 state of the reference asks.  In practice the
// products run at about half the FMA rate: their operands come from shared
// memory, and each thread's register tile sets how many FMAs a loaded
// value feeds.
//
// What this design does about it: it follows the reference's four steps
// (ssd_chunked), not the TPU kernel's walk over the chunks in order, so
// every chunk and head runs in parallel; only the recurrence across
// chunks is sequential, and it touches p * n numbers per (batch, head) and
// chunk.  Three launches on the caller's stream (two for a single chunk),
// with scratch the wrapper allocates; every CUDA kernel's name begins
// "ssd_":
// 1. ssd_chunk_states, one CTA per (chunk, group of heads, batch): each
//    head's cumulative log-decay (in the reference's order of additions: 8
//    lanes of one warp each add a block of 16 in sequence, every lane then
//    adds the 8 block totals in sequence from shuffles), to scratch for
//    the other passes; and the chunk's own state S^T (n, p) = B^T (x w),
//    w = exp(total - cs), from the chunk's data alone.  B is loaded once
//    for the group; each head's x arrives by cp.async while the last head
//    computes.  One more CTA per chunk makes C B^T, once for every head of
//    the batch, into scratch in the order the output pass's threads hold
//    it.  A single chunk needs no pass across chunks: its CTA writes the
//    state before the chunk (the initial state) and the final state.
// 2. ssd_state_pass, one CTA per (rows of S^T, head, batch):
//    prev[c] = carry; carry = carry exp(total_c) + states[c], from the
//    initial state, in the chunks' order; prev overwrites the chunk states
//    in place and the last carry is the final state.  The initial and
//    final states pass through shared memory, so every access is
//    coalesced; eight chunks' loads are in flight at once.
// 3. ssd_chunk_output, one CTA per (chunk, group of heads, part of p,
//    batch): for each head G^T = (C B^T) exp(segsum) in shared memory (the
//    decay masked before the exp, the triangle packed) and y = G x +
//    exp(cs) (C prev^T), G x cut at the diagonal; two heads at a time, one
//    per half of the CTA, each thread 8 rows by 8 columns.
// Heads per CTA (1, 2 or 4) and the p split (1 or 2) come from the shape
// and the SM count (ssd_plan in the wrapper), for the fewest head-times on
// the busiest SM.  y is written once, by pass 3; x is read by passes 1 and
// 3.  Not done yet: the tensor cores (3xTF32 split products would keep the
// tolerance; wgmma reads its operands from shared memory, which is what
// limits the FMAs here), TMA, and keeping a chunk's x on chip from pass 1
// to pass 3.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L = 128;          // steps per chunk
constexpr int SB = 16;          // block of the cumulative sum
constexpr int THREADS = 256;
constexpr int MAX_HG = 4;       // heads per CTA of the output pass
constexpr int MAX_DIM = 64;     // p and n
constexpr int STATE_BATCH = 8;  // chunks the state pass loads at once

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Cumulative sum of av[0..L) in the reference's order: XLA sums a long
// cumsum in blocks of SB in sequence, then adds the exclusive running sum
// of the block totals (exp(cs_i - cs_j) is a difference of two sums that
// reach -1e3 within a chunk, so each rounding of cs shows in y).  Called by
// a whole warp; lane k < L / SB gets steps k * SB .. + SB in v.  Returns
// cs[L - 1] in every lane.
__device__ __forceinline__ float chunk_cumsum(const float* av, int lane,
                                              float (&v)[SB]) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < SB; ++i) {
    if (lane < L / SB) run += av[lane * SB + i];
    v[i] = run;
  }
  float excl = 0.f, mine = 0.f;
#pragma unroll
  for (int k = 0; k < L / SB; ++k) {
    if (k == lane) mine = excl;
    excl += __shfl_sync(0xffffffffu, run, k);
  }
  if (lane < L / SB) {
#pragma unroll
    for (int i = 0; i < SB; ++i) v[i] += mine;
  }
  return __shfl_sync(0xffffffffu, v[SB - 1], L / SB - 1);
}

// A tile of rows of q4 16-byte pieces, cut over a CTA's threads once (a
// runtime division costs tens of instructions): this thread takes piece q
// of rows t0, t0 + step, ...; a thread past step * q4 takes none.
struct Pieces {
  int q, t0, step;
  __device__ Pieces(int q4, int threads)
      : q(threadIdx.x % q4), t0(threadIdx.x / q4), step(threads / q4) {
    if (int(threadIdx.x) >= step * q4) t0 = 1 << 30;
  }
};

// ---- pass 1: each chunk's cumulative decay and its own state ----------

// C B^T of a chunk, as the output pass's threads hold it: pair (r, q <= r)
// of thread (ty, tx) of a 16 x 16 layout is C_i . B_j for i = ty + 16 r,
// j = tx + 16 q (j > i is masked later), at (r (r + 1) / 2 + q) * 256 +
// thread; the pairs q > r are zero everywhere and not kept.
constexpr int CB_PAIRS = 36;
constexpr int CB_FLOATS = CB_PAIRS * 256;

// Shared memory, in floats: B [L][N + 4], two slots of x [L][P + 4] (in
// the C B^T CTA the second holds C [L][N + 4]), a then w [MAX_HG][L]; the
// same group of heads as the output pass
__host__ __device__ inline int states_slot(int P, int N) {
  return L * (P > N ? P + 4 : N + 4);
}
__host__ __device__ inline size_t states_smem_floats(int P, int N) {
  return size_t(L) * (N + 4) + 2 * size_t(states_slot(P, N)) +
         size_t(MAX_HG) * L;
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_chunk_states(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ Bm, const float* __restrict__ Cm,
                 const float* __restrict__ init, float* __restrict__ states,
                 float* __restrict__ cs_out, float* __restrict__ cb_out,
                 float* __restrict__ final_state, int l, int H, int P, int N,
                 int heads) {
  __shared__ float totals[MAX_HG];  // cs[L - 1] of each head
  extern __shared__ float4 smem4[];
  const int PX = P + 4;
  const int NX = N + 4;
  const int slot = states_slot(P, N);
  float* Bs = reinterpret_cast<float*>(smem4);  // [L][NX] B
  float* Xs = Bs + L * NX;                      // [2][slot] x, then x w
  float* Cs = Xs + slot;                        // [L][NX] C, in slot 1
  float* av = Xs + 2 * slot;                    // [MAX_HG][L] a, then w
  // the last CTA of each chunk makes C B^T alone, beside the heads' CTAs
  const bool makes_cb = blockIdx.y == gridDim.y - 1;

  const int c = blockIdx.x, h0 = blockIdx.y * heads, b = blockIdx.z;
  const int nc = gridDim.x;
  const int nh = min(heads, H - h0);
  const int c0 = c * L;
  const int Lc = min(L, l - c0);
  const int tid = threadIdx.x;
  const size_t xrow = size_t(H) * P;
  const float* xb = x + (size_t(b) * l + c0) * xrow + size_t(h0) * P;
  const float* Bb = Bm + (size_t(b) * l + c0) * N;

  const Pieces px(P / 4, THREADS), pb(N / 4, THREADS);
  // x of head hh into buffer buf (no commit)
  auto issue = [&](int hh, int buf) {
    const float* xh = xb + size_t(hh) * P + px.q * 4;
    float* xs = Xs + buf * slot + px.q * 4;
    for (int t = px.t0; t < L; t += px.step) {
      const bool ok = t < Lc;
      cp_async16(&xs[t * PX], ok ? xh + size_t(t) * xrow : xh, ok);
    }
  };
  const float* Cb = Cm + (size_t(b) * l + c0) * N;
  for (int t = pb.t0; t < L; t += pb.step) {
    const bool ok = t < Lc;
    const size_t at = ok ? size_t(t) * N + pb.q * 4 : 0;
    cp_async16(&Bs[t * NX + pb.q * 4], Bb + at, ok);
    if (makes_cb) cp_async16(&Cs[t * NX + pb.q * 4], Cb + at, ok);
  }
  if (makes_cb) {  // C B^T of the chunk, for every head's G
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int ty = tid / 16, tx = tid % 16;
    float cb[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) cb[r][q] = 0.f;
    for (int k = 0; k < N; k += 2) {  // k in order within each sum
      float2 cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cv[r] = *reinterpret_cast<const float2*>(&Cs[(ty + 16 * r) * NX + k]);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bv[q] = *reinterpret_cast<const float2*>(&Bs[(tx + 16 * q) * NX + k]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q)
          cb[r][q] = fmaf(cv[r].y, bv[q].y, fmaf(cv[r].x, bv[q].x, cb[r][q]));
    }
    float* out = cb_out + (size_t(b) * nc + c) * CB_FLOATS + tid;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) out[(r * (r + 1) / 2 + q) * 256] = cb[r][q];
    return;
  }
  issue(0, 0);
  cp_async_commit();
  for (int e = tid; e < nh * L; e += THREADS) {
    const int g = e / L, t = e % L;
    av[e] = t < Lc ? a[(size_t(b) * l + c0 + t) * H + h0 + g] : 0.f;
  }
  __syncthreads();
  // warp g: head g's cumulative log-decay, to scratch; w = exp(total - cs)
  const int warp = tid / 32, lane = tid % 32;
  if (warp < nh) {
    float v[SB];
    float* ag = av + warp * L;
    const float total = chunk_cumsum(ag, lane, v);
    if (lane == 0) totals[warp] = total;
    if (lane < L / SB) {
      float* out =
          cs_out + ((size_t(b) * nc + c) * H + h0 + warp) * L + lane * SB;
#pragma unroll
      for (int i = 0; i < SB; ++i) {
        out[i] = v[i];
        ag[lane * SB + i] = expf(total - v[i]);  // this lane's own steps
      }
    }
  }

  // S^T[k][p] = sum_j (x w)[j][p] B[j][k]: p0 .. +4 by k0 .. +4 a thread,
  // neighbouring lanes on neighbouring p (the stores run along p)
  const int p0 = (tid % 16) * 4, k0 = (tid / 16) * 4;
  const bool mine = p0 < P && k0 < N;
  for (int hh = 0; hh < nh; ++hh) {
    const int buf = hh & 1;
    __syncthreads();  // w is ready, or the last head's x is read
    if (hh + 1 < nh) {
      issue(hh + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float* xs = Xs + buf * slot;
    const float* w = av + hh * L;
    for (int t = px.t0; t < Lc; t += px.step) {
      float4* v = reinterpret_cast<float4*>(&xs[t * PX + px.q * 4]);
      const float wt = w[t];
      float4 u = *v;
      u.x *= wt, u.y *= wt, u.z *= wt, u.w *= wt;
      *v = u;
    }
    __syncthreads();
    if (!mine) continue;
    float acc[4][4];
#pragma unroll
    for (int pi = 0; pi < 4; ++pi)
#pragma unroll
      for (int ki = 0; ki < 4; ++ki) acc[pi][ki] = 0.f;
#pragma unroll 4
    for (int j = 0; j < Lc; ++j) {  // missing steps have x = 0
      const float4 xv = *reinterpret_cast<const float4*>(&xs[j * PX + p0]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[j * NX + k0]);
      const float xq4[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bq4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int pi = 0; pi < 4; ++pi)
#pragma unroll
        for (int ki = 0; ki < 4; ++ki)
          acc[pi][ki] = fmaf(xq4[pi], bq4[ki], acc[pi][ki]);
    }
    const int h = h0 + hh;
    float* st = states + ((size_t(b) * nc + c) * H + h) * size_t(N) * P;
    if (nc > 1) {
#pragma unroll
      for (int ki = 0; ki < 4; ++ki)
        *reinterpret_cast<float4*>(&st[size_t(k0 + ki) * P + p0]) =
            make_float4(acc[0][ki], acc[1][ki], acc[2][ki], acc[3][ki]);
      continue;
    }
    // one chunk needs no pass across chunks: the state before it is the
    // initial state, and the final state is init exp(total) + this state
    const float dec = expf(totals[hh]);
    const size_t at = (size_t(b) * H + h) * P * N;
    float s0[4][4];
#pragma unroll
    for (int pi = 0; pi < 4; ++pi) {
      const float4 v = init ? *reinterpret_cast<const float4*>(
                                  &init[at + size_t(p0 + pi) * N + k0])
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      s0[pi][0] = v.x, s0[pi][1] = v.y, s0[pi][2] = v.z, s0[pi][3] = v.w;
      *reinterpret_cast<float4*>(
          &final_state[at + size_t(p0 + pi) * N + k0]) =
          make_float4(fmaf(v.x, dec, acc[pi][0]), fmaf(v.y, dec, acc[pi][1]),
                      fmaf(v.z, dec, acc[pi][2]), fmaf(v.w, dec, acc[pi][3]));
    }
#pragma unroll
    for (int ki = 0; ki < 4; ++ki)
      *reinterpret_cast<float4*>(&st[size_t(k0 + ki) * P + p0]) =
          make_float4(s0[0][ki], s0[1][ki], s0[2][ki], s0[3][ki]);
  }
}

// ---- pass 2: the recurrence across chunks -----------------------------

constexpr int EPT = 4;  // state elements a thread
constexpr int TILE = EPT * THREADS;

// rows k of S^T one CTA takes: at most TILE elements
__host__ __device__ inline int pass_rows(int P, int N) {
  return min(N, TILE / P);
}

// prev[c] = carry; carry = carry exp(total_c) + states[c], from the
// initial state, for rows k0 .. k0 + KT of S^T (the scratch's layout,
// k * P + p) of one (batch, head); prev overwrites the chunk states in
// place and the last carry is the final state.  init and final (b, h, p,
// n) pass through a shared tile, so every global access is coalesced.
__global__ void __launch_bounds__(THREADS)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ cs,
               const float* __restrict__ init,
               float* __restrict__ final_state, int nc, int H, int P,
               int N) {
  __shared__ float tile[TILE + MAX_DIM];  // [P][KT + 1]
  const int KT = pass_rows(P, N);
  const int TP = KT + 1;
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int kn = min(KT, N - k0);
  const int tid = threadIdx.x;
  const int PN = P * N;
  const size_t bh = size_t(b) * H + h;
  for (int e = tid; e < kn * P; e += THREADS) {
    const int p = e / kn, kk = e % kn;
    tile[p * TP + kk] = init ? init[bh * PN + size_t(p) * N + k0 + kk] : 0.f;
  }
  __syncthreads();
  float carry[EPT];
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int r = tid + u * THREADS;  // kk * P + p
    carry[u] = r < kn * P ? tile[(r % P) * TP + r / P] : 0.f;
  }
  const size_t cstride = size_t(H) * PN;  // one chunk of the scratch
  float* sp = states + (size_t(b) * nc * H + h) * PN + size_t(k0) * P;
  const float* last = cs + (size_t(b) * nc * H + h) * L + (L - 1);
  for (int c0 = 0; c0 < nc; c0 += STATE_BATCH) {
    float s[STATE_BATCH][EPT], dec[STATE_BATCH];
#pragma unroll
    for (int v = 0; v < STATE_BATCH; ++v) {
      if (c0 + v >= nc) break;
      dec[v] = expf(last[size_t(c0 + v) * H * L]);
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int r = tid + u * THREADS;
        if (r < kn * P) s[v][u] = sp[size_t(c0 + v) * cstride + r];
      }
    }
#pragma unroll
    for (int v = 0; v < STATE_BATCH; ++v) {
      if (c0 + v >= nc) break;
#pragma unroll
      for (int u = 0; u < EPT; ++u) {
        const int r = tid + u * THREADS;
        if (r < kn * P) {
          sp[size_t(c0 + v) * cstride + r] = carry[u];  // prev of c0 + v
          carry[u] = fmaf(carry[u], dec[v], s[v][u]);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < EPT; ++u) {
    const int r = tid + u * THREADS;
    if (r < kn * P) tile[(r % P) * TP + r / P] = carry[u];
  }
  __syncthreads();
  for (int e = tid; e < kn * P; e += THREADS) {
    const int p = e / kn, kk = e % kn;
    final_state[bh * PN + size_t(p) * N + k0 + kk] = tile[p * TP + kk];
  }
}

// ---- pass 3: the outputs ----------------------------------------------

// G^T in shared memory, packed by blocks of 16 rows j: block jb keeps the
// columns i >= 16 jb (G[i][j] = 0 for i < j) at a pitch of 132 - 16 jb
__host__ __device__ constexpr int gt_offset(int jb) {
  return 2112 * jb - 128 * jb * (jb - 1);
}
__host__ __device__ constexpr int gt_pitch(int jb) { return 132 - 16 * jb; }
constexpr int GT_FLOATS = gt_offset(L / 16);
// where G^T[j][i] would be, i >= 16 (j / 16) for it to be stored
__device__ __forceinline__ int gt_at(int j, int i) {
  const int jb = j / 16;
  return gt_offset(jb) + (j % 16) * gt_pitch(jb) + i - 16 * jb;
}

// Each half of the CTA (128 threads) computes y of its own head, two heads
// at a time, so a thread holds 8 columns: a G value and an x value loaded
// from shared memory feed twice the FMAs they would with 4 columns (the
// loads, not the FMAs, set the pace otherwise).  A thread's RPT rows are
// two runs of RPT / 2: rows (RPT / 2) a .. + RPT / 2 and their mirror from
// the end of the chunk, so every thread has the same share of the
// triangle G x.  RPT = 8 for a tile of 64 p columns, 4 for one of 32.
constexpr int HALF = THREADS / 2;

template <int RPT>
struct OutLayout {
  static constexpr int H2 = RPT / 2;
  static constexpr int CG = HALF / (L / RPT);  // column groups of 8
  static constexpr int PT = CG * 8;            // p columns of the tile
  static constexpr int PX = PT + 4;
  // C [L][N + 4]; G^T packed [2]; x [2][L][PX]; prev^T [2][N][PX];
  // cs [MAX_HG][L]
  static __host__ __device__ size_t floats(int N) {
    return size_t(L) * (N + 4) + 2 * GT_FLOATS + 2 * size_t(L) * PX +
           2 * size_t(N) * PX + size_t(MAX_HG) * L;
  }
};

template <int H2>
__device__ __forceinline__ void load_run(const float* p, float (&v)[H2]);
template <>
__device__ __forceinline__ void load_run<4>(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}
template <>
__device__ __forceinline__ void load_run<2>(const float* p, float (&v)[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x, v[1] = q.y;
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

template <int RPT>
__global__ void __launch_bounds__(THREADS, 1)
ssd_chunk_output(const float* __restrict__ x, const float* __restrict__ cbs,
                 const float* __restrict__ Cm, const float* __restrict__ cs,
                 const float* __restrict__ prev, float* __restrict__ y,
                 int l, int H, int P, int N, int heads, int split) {
  using Lay = OutLayout<RPT>;
  constexpr int H2 = Lay::H2, CG = Lay::CG, PX = Lay::PX;
  extern __shared__ float4 smem4[];
  const int NX = N + 4;
  float* Cs = reinterpret_cast<float*>(smem4);  // [L][NX] C
  float* Gt = Cs + L * NX;                      // [2] G^T, packed
  float* Xs = Gt + 2 * GT_FLOATS;               // [2][L][PX]
  float* Ss = Xs + 2 * L * PX;                  // [2][N][PX] prev^T
  float* csg = Ss + 2 * N * PX;                 // [MAX_HG][L]

  const int c = blockIdx.x, nc = gridDim.x;
  const int part = blockIdx.y % split, grp = blockIdx.y / split;
  const int b = blockIdx.z;
  const int c0 = c * L;
  const int Lc = min(L, l - c0);
  const int PS = P / split, p0 = part * PS;
  const int h0 = grp * heads, nh = min(heads, H - h0);
  const int tid = threadIdx.x;
  const size_t xrow = size_t(H) * P;
  const size_t row0 = size_t(b) * l + c0;  // the chunk's first step
  const size_t PN = size_t(P) * N;

  const Pieces pp(PS / 4, THREADS), pn(N / 4, THREADS);
  // x tile and prev^T of head h0 + hh into slot (no commit)
  auto issue = [&](int hh, int slot) {
    const int h = h0 + hh;
    const float* xh = x + row0 * xrow + size_t(h) * P + p0 + pp.q * 4;
    float* xs = Xs + slot * L * PX + pp.q * 4;
    for (int t = pp.t0; t < L; t += pp.step) {
      const bool ok = t < Lc;
      cp_async16(xs + t * PX, ok ? xh + size_t(t) * xrow : xh, ok);
    }
    const float* sh =
        prev + ((size_t(b) * nc + c) * H + h) * PN + p0 + pp.q * 4;
    float* ss = Ss + slot * N * PX + pp.q * 4;
    for (int k = pp.t0; k < N; k += pp.step)
      cp_async16(ss + k * PX, sh + size_t(k) * P, true);
  };
  // C of the chunk (missing steps zero), the group's cs and the first two
  // heads' tiles, as one group
  for (int t = pn.t0; t < L; t += pn.step) {
    const bool ok = t < Lc;
    const size_t at = ok ? (row0 + t) * N + pn.q * 4 : row0 * N;
    cp_async16(Cs + t * NX + pn.q * 4, Cm + at, ok);
  }
  {
    const float* csb = cs + ((size_t(b) * nc + c) * H + h0) * L;
    for (int e = tid; e < nh * L / 4; e += THREADS)
      cp_async16(csg + e * 4, csb + e * 4, true);
  }
  for (int hh = 0; hh < min(nh, 2); ++hh) issue(hh, hh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T of the chunk from the chunk pass: rows i = ty + 16 r, columns
  // j = tx + 16 q, the pairs q <= r
  const int ty = tid / 16, tx = tid % 16;
  float cb[8][8];
  {
    const float* in = cbs + (size_t(b) * nc + c) * CB_FLOATS + tid;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q <= r; ++q) cb[r][q] = in[(r * (r + 1) / 2 + q) * 256];
  }

  // this thread's head slot, rows lo .. lo + H2 and hi .. hi + H2, and 8
  // columns of the p part
  const int slot = tid / HALF, tg = tid % HALF;
  const int pair = tg / CG;
  const int lo = pair * H2, hi = L - (pair + 1) * H2;
  const int col = (tg % CG) * 8;
  const int j_lo = min(lo + H2, Lc), j_hi = min(hi + H2, Lc);
  for (int h2 = 0; h2 < nh; h2 += 2) {
    const int nr = min(2, nh - h2);  // heads of this round
    if (h2 > 0) {
      __syncthreads();  // the last round's G^T and tiles are read
      for (int s2 = 0; s2 < nr; ++s2) issue(h2 + s2, s2);
      cp_async_commit();
    }
    // G^T of the round's heads
    for (int s2 = 0; s2 < nr; ++s2) {
      const float* csh = csg + (h2 + s2) * L;
      float* gt = Gt + s2 * GT_FLOATS;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = ty + 16 * r;
        const float cs_i = csh[i];
#pragma unroll
        for (int q = 0; q <= r; ++q) {
          const int j = tx + 16 * q;
          // mask before exp: exp(cs_i - cs_j) may overflow for j > i
          gt[gt_at(j, i)] = j <= i ? cb[r][q] * expf(cs_i - csh[j]) : 0.f;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    if (slot >= nr || col >= PS) continue;
    const int hh = h2 + slot;
    const float* gt = Gt + slot * GT_FLOATS;
    const float* xs = Xs + slot * L * PX;
    const float* ss = Ss + slot * N * PX;
    const float* csh = csg + hh * L;
    float acc[2][H2][8], acs[2][H2][8];
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
      for (int r = 0; r < H2; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[s2][r][q] = acs[s2][r][q] = 0.f;
    // G x: G is zero past the diagonal and x past the chunk's end; both
    // runs up to the low run's diagonal, then the high run alone, a block
    // of 16 rows of G^T at a time
    for (int jb = 0; jb * 16 < j_hi; ++jb) {
      const int pitch = gt_pitch(jb);
      const float* gp = gt + gt_offset(jb) - 16 * jb;  // + (j % 16) pitch + i
      const float* xp = xs + 16 * jb * PX + col;
      const int both = min(j_lo - 16 * jb, 16), end = min(j_hi - 16 * jb, 16);
      int jj = 0;
      for (; jj < both; ++jj, gp += pitch, xp += PX) {
        float gl[H2], gh[H2], xv[8];
        load_run<H2>(gp + lo, gl);
        load_run<H2>(gp + hi, gh);
        load8(xp, xv);
#pragma unroll
        for (int r = 0; r < H2; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc[0][r][q] = fmaf(gl[r], xv[q], acc[0][r][q]);
            acc[1][r][q] = fmaf(gh[r], xv[q], acc[1][r][q]);
          }
      }
      for (; jj < end; ++jj, gp += pitch, xp += PX) {
        float gh[H2], xv[8];
        load_run<H2>(gp + hi, gh);
        load8(xp, xv);
#pragma unroll
        for (int r = 0; r < H2; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[1][r][q] = fmaf(gh[r], xv[q], acc[1][r][q]);
      }
    }
    // C prev^T, k in order within each sum
    for (int k = 0; k < N; k += 4) {
      float4 cl[H2], ch[H2];
#pragma unroll
      for (int r = 0; r < H2; ++r) {
        cl[r] = *reinterpret_cast<const float4*>(&Cs[(lo + r) * NX + k]);
        ch[r] = *reinterpret_cast<const float4*>(&Cs[(hi + r) * NX + k]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float sv[8];
        load8(&ss[(k + kk) * PX + col], sv);
#pragma unroll
        for (int r = 0; r < H2; ++r) {
          const float c_l = kk == 0 ? cl[r].x : kk == 1 ? cl[r].y
                          : kk == 2 ? cl[r].z : cl[r].w;
          const float c_h = kk == 0 ? ch[r].x : kk == 1 ? ch[r].y
                          : kk == 2 ? ch[r].z : ch[r].w;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acs[0][r][q] = fmaf(c_l, sv[q], acs[0][r][q]);
            acs[1][r][q] = fmaf(c_h, sv[q], acs[1][r][q]);
          }
        }
      }
    }
    float* yh = y + row0 * xrow + size_t(h0 + hh) * P + p0 + col;
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2)
#pragma unroll
      for (int r = 0; r < H2; ++r) {
        const int i = (s2 ? hi : lo) + r;
        if (i >= Lc) continue;
        const float e = expf(csh[i]);
        float o[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) o[q] = fmaf(e, acs[s2][r][q], acc[s2][r][q]);
        *reinterpret_cast<float4*>(&yh[size_t(i) * xrow]) =
            make_float4(o[0], o[1], o[2], o[3]);
        if (col + 4 < PS)
          *reinterpret_cast<float4*>(&yh[size_t(i) * xrow + 4]) =
              make_float4(o[4], o[5], o[6], o[7]);
      }
  }
}

template <int RPT>
cudaError_t launch_output(const float* x, const float* cbs, const float* C,
                          const float* cs, const float* prev, float* y,
                          int batch, int l, int H, int P, int N, int heads,
                          int split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * OutLayout<RPT>::floats(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_output<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return err;
  const int nc = (l + L - 1) / L;
  const dim3 grid(nc, ((H + heads - 1) / heads) * split, batch);
  ssd_chunk_output<RPT><<<grid, THREADS, smem, stream>>>(
      x, cbs, C, cs, prev, y, l, H, P, N, heads, split);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry.  init may be null (a zero initial state).  states
// (batch, chunks, H, N, P), cs (batch, chunks, H, 128) and cbs (batch,
// chunks, CB_FLOATS) are f32 scratch from the caller; heads (1 to 4) and
// split (1, or 2 where P / 2 is a multiple of 4) are the plan.  Three
// launches on stream, two for a single chunk (l = 0: a copy of init, or
// zeros, to the final state).  With y null the output pass is left out:
// the backward (ssd_scan_bwd.cu) takes states (the state before each chunk)
// and cs from the first two passes.  Returns the CUDA error code of the first
// launch that failed (0 = all launched), or cudaErrorInvalidValue for what
// the kernels do not take.
extern "C" int repro_ssd_scan(const void* x, const void* a, const void* B,
                              const void* C, const void* init, void* y,
                              void* final_state, void* states, void* cs,
                              void* cbs, int batch, int l, int H, int P,
                              int N, int heads, int split, void* stream) {
  if (heads < 1 || heads > MAX_HG || split < 1 || split > 2 ||
      P % (4 * split) || P < 4 || P > MAX_DIM || N % 4 || N < 4 ||
      N > MAX_DIM)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t state_bytes = sizeof(float) * batch * H * P * N;
  const int nc = (l + L - 1) / L;
  if (nc == 0)
    return int(init ? cudaMemcpyAsync(final_state, init, state_bytes,
                                      cudaMemcpyDeviceToDevice, s)
                    : cudaMemsetAsync(final_state, 0, state_bytes, s));
  const float* xf = static_cast<const float*>(x);
  const float* Cf = static_cast<const float*>(C);
  const float* initf = static_cast<const float*>(init);
  float* finalf = static_cast<float*>(final_state);
  float* st = static_cast<float*>(states);
  float* csf = static_cast<float*>(cs);
  float* cbf = static_cast<float*>(cbs);

  const size_t smem1 = sizeof(float) * states_smem_floats(P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_states, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem1));
  if (err != cudaSuccess) return int(err);
  const int groups = (H + heads - 1) / heads;
  ssd_chunk_states<<<dim3(nc, groups + 1, batch), THREADS, smem1, s>>>(
      xf, static_cast<const float*>(a), static_cast<const float*>(B), Cf,
      initf, st, csf, cbf, finalf, l, H, P, N, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);

  if (nc > 1) {
    const int KT = pass_rows(P, N);
    ssd_state_pass<<<dim3((N + KT - 1) / KT, H, batch), THREADS, 0, s>>>(
        st, csf, initf, finalf, nc, H, P, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
  }

  if (!y) return 0;
  float* yf = static_cast<float*>(y);
  err = P / split > 32
            ? launch_output<8>(xf, cbf, Cf, csf, st, yf, batch, l, H, P, N,
                               heads, split, s)
            : launch_output<4>(xf, cbf, Cf, csf, st, yf, batch, l, H, P, N,
                               heads, split, s);
  return int(err);
}
