// Phase-1 frame Viterbi score kernel for NVIDIA Hopper, called from JAX
// through the XLA foreign function interface (ops/viterbi_cuda.py).
//
// One thread block scores one (profile, window) pair over the whole
// window: the position loop runs inside the block, so a window costs one
// launch instead of one XLA step per nucleotide.  It returns the same two
// costs as ops/viterbi_jax.py `viterbi` + `viterbi_null`, bit for bit: the
// recurrence is fp32 additions and minima only, and every candidate keeps
// the association of the plain engine, (prev + trans) + emission.
//
// Layout (built by viterbi_cuda.build_tables):
//   tables (P, 1364, Kw) f32: match emission costs in columns [0, K),
//     +inf pads up to Kw-2, the null emission in column Kw-2 and the
//     background (insert) emission in column Kw-1, so one row read serves
//     the core states and the special states.
//   tvecs (P, 9, Kw) f32: destination-indexed transition rows in the
//     ops/costs.py order BM MM MI MD IM II DM DD DDCUM, +inf pads, DDCUM
//     the saturated cumsum of the padded DD row.
//   codes (T, 5) i32: START-indexed fragment codes of the scan
//     (scan/scheduler.py DeviceSeqCodes): row g, column t-1 is the code of
//     the length-t fragment that starts at global position g.
//
// Nodes: thread i owns the contiguous run [i*R, i*R+R) of the Kn =
// blockDim.x * R nodes (Kn <= Kw - 4).  The neighbour k-1 is in-thread
// except at a run's first node, which takes it from the previous lane by
// a warp shuffle and across warps through shared memory.
//
// Pending form: the M and I values of position j are the minima of the
// candidates pushed into them from positions j-1..j-5.  A 5-slot ring of
// those pending minima (slot = position mod 5) replaces the reference's
// 5-deep rings of M/I/D, and the pushes of position l read the fragments
// that START at l, one row of the start-indexed code table.  The position
// loop is unrolled by 5 so every ring slot index is a compile-time
// constant (the ring stays in registers).
//
// Delete chain: D[k] = min_{j<=k}(A[j] - S[j]) + S[k] with A[k] =
// M[k-1] + MD[k] and S the DDCUM row: a thread-local prefix min over the
// run, a warp scan of the run minima, then the minima of the preceding
// warps from shared memory.  A minimum is exact in any order, so this
// equals the plain engine's lax.cummin.
//
// State storage: R <= 8 keeps the pending ring and the transition rows in
// registers.  R = 16 (K past 2048) keeps the ring in a global scratch
// buffer (an extra result of the call) and reads the transition rows from
// L1/L2 at every position: such a block's DP state does not fit one SM's
// register file.

#include <cstdint>
#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kTable = 1364;  // fragment codes (frame.TABLE_SIZE)
constexpr int kRows = 9;      // tvec rows
constexpr unsigned kFull = 0xffffffffu;

// tvec rows (ops/costs.py CT_*)
constexpr int BM = 0, MM = 1, MI = 2, MD = 3, IM = 4, II = 5, DM = 6,
              DDCUM = 8;
// xtrans cost vector slots (xtrans.py XT_*)
constexpr int XRR = 0, XSN = 1, XNN = 2, XSB = 3, XNB = 4, XEB = 5,
              XJB = 6, XEJ = 7, XJJ = 8, XEC = 9, XCC = 10, XET = 11,
              XCT = 12;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Pending M (slots 0..4) and I (slots 5..9) minima of the thread's nodes.
template <int R, bool MEM>
struct Ring;

template <int R>
struct Ring<R, false> {
  float v[10][R];
  __device__ __forceinline__ void init(float*, int, int, int) {
#pragma unroll
    for (int s = 0; s < 10; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) v[s][r] = inf();
  }
  __device__ __forceinline__ float& at(int s, int r) { return v[s][r]; }
};

template <int R>
struct Ring<R, true> {
  float* base;  // this thread's first node in slot 0
  int stride;   // Kn: floats between slots
  __device__ __forceinline__ void init(float* scratch, int pair, int kn,
                                       int k0) {
    base = scratch + (size_t)pair * 10 * kn + k0;
    stride = kn;
#pragma unroll
    for (int s = 0; s < 10; ++s)
#pragma unroll
      for (int r = 0; r < R; ++r) base[s * stride + r] = inf();
  }
  __device__ __forceinline__ float& at(int s, int r) {
    return base[s * stride + r];
  }
};

// Transition rows of the thread's nodes.
template <int R, bool MEM>
struct Trans;

template <int R>
struct Trans<R, false> {
  float v[kRows][R];
  __device__ __forceinline__ void init(const float* tv, int kw, int k0) {
#pragma unroll
    for (int q = 0; q < kRows; ++q)
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        float4 x = __ldg(reinterpret_cast<const float4*>(tv + q * kw + k0 + r));
        v[q][r] = x.x;
        v[q][r + 1] = x.y;
        v[q][r + 2] = x.z;
        v[q][r + 3] = x.w;
      }
  }
  __device__ __forceinline__ float get(int q, int r) const { return v[q][r]; }
};

template <int R>
struct Trans<R, true> {
  const float* p;  // this thread's first node in row 0
  int kw;
  __device__ __forceinline__ void init(const float* tv, int kw_, int k0) {
    p = tv + k0;
    kw = kw_;
  }
  __device__ __forceinline__ float get(int q, int r) const {
    return __ldg(p + q * kw + r);
  }
};

struct Specials {
  // pending minima of the scalar states, slot = position mod 5
  float n[5], j[5], c[5], rr[5];
};

struct Xt {
  float RR, SN, NN, SB, NB, EB, JB, EJ, JJ, EC, CC, ET, CT;
};

template <int R>
__device__ __forceinline__ void load_row(const float* row, int k0, float (&e)[R]) {
#pragma unroll
  for (int r = 0; r < R; r += 4) {
    float4 x = __ldg(reinterpret_cast<const float4*>(row + k0 + r));
    e[r] = x.x;
    e[r + 1] = x.y;
    e[r + 2] = x.z;
    e[r + 3] = x.w;
  }
}

// Push the candidates of source position l (state M, I, D, N, B, E, J,
// C, Rn, and S = 0 only at l == 0) into the five pending slots l+1..l+5.
// Ms/Is/Ds are the k-1 neighbours of M/I/D.
template <int R, bool MEM, int SLOT>
__device__ __forceinline__ void push(
    Ring<R, MEM>& ring, const Trans<R, MEM>& tr, Specials& sp, const Xt& x,
    const float* tab, int kw, int k0, const int* crow, const float (&M)[R],
    const float (&I)[R], const float (&Ms)[R], const float (&Is)[R],
    const float (&Ds)[R], float S, float N, float B, float E, float J,
    float C, float Rn) {
  int code[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) code[t] = __ldg(crow + t);
#pragma unroll
  for (int t = 1; t <= 5; ++t) {
    const int U = (SLOT + t) % 5;  // constant once unrolled
    const float* row = tab + (size_t)code[t - 1] * kw;
    const float nil = __ldg(row + kw - 2);
    const float bgv = __ldg(row + kw - 1);
    float e[R];
    load_row<R>(row, k0, e);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = ring.at(U, r);
      m = fminf(m, (B + tr.get(BM, r)) + e[r]);
      m = fminf(m, (Ms[r] + tr.get(MM, r)) + e[r]);
      m = fminf(m, (Is[r] + tr.get(IM, r)) + e[r]);
      m = fminf(m, (Ds[r] + tr.get(DM, r)) + e[r]);
      ring.at(U, r) = m;
      float i = ring.at(5 + U, r);
      i = fminf(i, (I[r] + tr.get(II, r)) + bgv);
      i = fminf(i, (M[r] + tr.get(MI, r)) + bgv);
      ring.at(5 + U, r) = i;
    }
    sp.n[U] = fminf(sp.n[U], fminf((S + x.SN) + nil, (N + x.NN) + nil));
    sp.j[U] = fminf(sp.j[U], fminf((E + x.EJ) + nil, (J + x.JJ) + nil));
    sp.c[U] = fminf(sp.c[U], fminf((E + x.EC) + nil, (C + x.CC) + nil));
    sp.rr[U] = fminf(sp.rr[U], (Rn + x.RR) + nil);
  }
}

struct Shared {
  float m[32], i[32], g[32], d[32], e[32];
};

// One DP position l (slot SLOT = l mod 5).  Returns T_l; R_l in *rn.
template <int R, bool MEM, int SLOT>
__device__ __forceinline__ float step(
    Ring<R, MEM>& ring, const Trans<R, MEM>& tr, Specials& sp, const Xt& x,
    Shared& sh, const float* tab, int kw, int k0, const int* codes,
    int gs, int l, int L, float* rn) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;

  float M[R], I[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    M[r] = ring.at(SLOT, r);
    I[r] = ring.at(5 + SLOT, r);
    ring.at(SLOT, r) = inf();
    ring.at(5 + SLOT, r) = inf();
  }
  const float N = sp.n[SLOT], J = sp.j[SLOT], C = sp.c[SLOT];
  const float Rn = sp.rr[SLOT];
  sp.n[SLOT] = sp.j[SLOT] = sp.c[SLOT] = sp.rr[SLOT] = inf();

  // k-1 neighbours of the run's first node
  float m_in = __shfl_up_sync(kFull, M[R - 1], 1);
  float i_in = __shfl_up_sync(kFull, I[R - 1], 1);
  if (nw > 1) {
    if (lane == 31) {
      sh.m[warp] = M[R - 1];
      sh.i[warp] = I[R - 1];
    }
    __syncthreads();
  }
  if (lane == 0) {
    m_in = warp ? sh.m[warp - 1] : inf();
    i_in = warp ? sh.i[warp - 1] : inf();
  }
  float Ms[R], Is[R];
  Ms[0] = m_in;
  Is[0] = i_in;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    Ms[r] = M[r - 1];
    Is[r] = I[r - 1];
  }

  // delete chain: prefix min of G = A - S over all nodes
  float D[R];
  float run = inf();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float g = (Ms[r] + tr.get(MD, r)) - tr.get(DDCUM, r);
    run = fminf(run, g);
    D[r] = run;
  }
  float v = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v = fminf(v, u);
  }
  float before = __shfl_up_sync(kFull, v, 1);
  if (lane == 0) before = inf();
  if (nw > 1) {
    if (lane == 31) sh.g[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = fminf(before, sh.g[w]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) D[r] = fminf(before, D[r]) + tr.get(DDCUM, r);

  // E = min over nodes of min(M, D); D's k-1 neighbour
  float e = inf();
#pragma unroll
  for (int r = 0; r < R; ++r) e = fminf(e, fminf(M[r], D[r]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) e = fminf(e, __shfl_xor_sync(kFull, e, o));
  float d_in = __shfl_up_sync(kFull, D[R - 1], 1);
  if (nw > 1) {
    if (lane == 31) sh.d[warp] = D[R - 1];
    if (lane == 0) sh.e[warp] = e;
    __syncthreads();
    e = inf();
    for (int w = 0; w < nw; ++w) e = fminf(e, sh.e[w]);
  }
  if (lane == 0) d_in = warp ? sh.d[warp - 1] : inf();
  const float E = e;

  const float B = fminf(fminf(N + x.NB, E + x.EB), J + x.JB);
  const float T = fminf(E + x.ET, C + x.CT);
  *rn = Rn;

  if (l < L) {
    float Ds[R];
    Ds[0] = d_in;
#pragma unroll
    for (int r = 1; r < R; ++r) Ds[r] = D[r - 1];
    push<R, MEM, SLOT>(ring, tr, sp, x, tab, kw, k0,
                       codes + (size_t)(gs + l) * 5, M, I, Ms, Is, Ds,
                       inf(), N, B, E, J, C, Rn);
  }
  return T;
}

template <int R, bool MEM>
__global__ void __launch_bounds__(MEM ? 1024 : 256)
    score_kernel(const float* __restrict__ tables,
                 const float* __restrict__ tvecs,
                 const int* __restrict__ codes,
                 const int* __restrict__ pidx,
                 const int* __restrict__ starts,
                 const int* __restrict__ lens,
                 const float* __restrict__ xts, float* __restrict__ alt,
                 float* __restrict__ nul, float* __restrict__ scratch,
                 int kw) {
  __shared__ Shared sh;
  const int pair = blockIdx.x;
  const int kn = blockDim.x * R;
  const int k0 = threadIdx.x * R;
  const int p = pidx[pair];
  const int L = lens[pair];
  const int gs = starts[pair];
  const float* tab = tables + (size_t)p * kTable * kw;
  const float* xv = xts + (size_t)pair * 16;
  Xt x;
  x.RR = xv[XRR];
  x.SN = xv[XSN];
  x.NN = xv[XNN];
  x.SB = xv[XSB];
  x.NB = xv[XNB];
  x.EB = xv[XEB];
  x.JB = xv[XJB];
  x.EJ = xv[XEJ];
  x.JJ = xv[XJJ];
  x.EC = xv[XEC];
  x.CC = xv[XCC];
  x.ET = xv[XET];
  x.CT = xv[XCT];

  Ring<R, MEM> ring;
  ring.init(scratch, pair, kn, k0);
  Trans<R, MEM> tr;
  tr.init(tvecs + (size_t)p * kRows * kw, kw, k0);
  Specials sp;
#pragma unroll
  for (int s = 0; s < 5; ++s) sp.n[s] = sp.j[s] = sp.c[s] = sp.rr[s] = inf();

  float T = inf(), Rl = inf();
  if (L > 0) {
    // position 0: S = 0, B = SB, R = -RR, every other state +inf
    float none[R];
#pragma unroll
    for (int r = 0; r < R; ++r) none[r] = inf();
    push<R, MEM, 0>(ring, tr, sp, x, tab, kw, k0, codes + (size_t)gs * 5,
                    none, none, none, none, none, 0.0f, inf(), x.SB, inf(),
                    inf(), inf(), -x.RR);
  }
  for (int l = 1; l <= L; l += 5) {
    T = step<R, MEM, 1>(ring, tr, sp, x, sh, tab, kw, k0, codes, gs, l, L, &Rl);
    if (l + 1 > L) break;
    T = step<R, MEM, 2>(ring, tr, sp, x, sh, tab, kw, k0, codes, gs, l + 1, L, &Rl);
    if (l + 2 > L) break;
    T = step<R, MEM, 3>(ring, tr, sp, x, sh, tab, kw, k0, codes, gs, l + 2, L, &Rl);
    if (l + 3 > L) break;
    T = step<R, MEM, 4>(ring, tr, sp, x, sh, tab, kw, k0, codes, gs, l + 3, L, &Rl);
    if (l + 4 > L) break;
    T = step<R, MEM, 0>(ring, tr, sp, x, sh, tab, kw, k0, codes, gs, l + 4, L, &Rl);
  }
  if (threadIdx.x == 0) {
    alt[pair] = T;
    nul[pair] = Rl;
  }
}

template <int R, bool MEM>
cudaError_t launch(cudaStream_t stream, int n, int threads,
                   const float* tables, const float* tvecs, const int* codes,
                   const int* pidx, const int* starts, const int* lens,
                   const float* xts, float* alt, float* nul, float* scratch,
                   int kw) {
  score_kernel<R, MEM><<<n, threads, 0, stream>>>(
      tables, tvecs, codes, pidx, starts, lens, xts, alt, nul, scratch, kw);
  return cudaGetLastError();
}

ffi::Error ScoreImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> tables,
                     ffi::Buffer<ffi::F32> tvecs, ffi::Buffer<ffi::S32> codes,
                     ffi::Buffer<ffi::S32> pidx, ffi::Buffer<ffi::S32> starts,
                     ffi::Buffer<ffi::S32> lens, ffi::Buffer<ffi::F32> xts,
                     ffi::ResultBuffer<ffi::F32> alt,
                     ffi::ResultBuffer<ffi::F32> nul,
                     ffi::ResultBuffer<ffi::F32> scratch, int64_t threads,
                     int64_t nodes_per_thread) {
  const auto td = tables.dimensions();
  const auto vd = tvecs.dimensions();
  if (td.size() != 3 || td[1] != kTable || vd.size() != 3 ||
      vd[1] != kRows || vd[0] != td[0] || vd[2] != td[2])
    return ffi::Error::InvalidArgument("bad table shapes");
  const int64_t kw = td[2];
  const int64_t kn = threads * nodes_per_thread;
  if (threads % 32 || threads < 32 || kn + 4 > kw || kw % 4)
    return ffi::Error::InvalidArgument("bad launch shape for table width");
  const int64_t n = pidx.element_count();
  if (starts.element_count() != n || lens.element_count() != n ||
      xts.element_count() != n * 16 || alt->element_count() != n ||
      nul->element_count() != n)
    return ffi::Error::InvalidArgument("bad pair arrays");
  if (n == 0) return ffi::Error::Success();
  cudaError_t err;
  switch (nodes_per_thread) {
    case 4:
      if (threads > 256) return ffi::Error::InvalidArgument("threads > 256");
      err = launch<4, false>(stream, n, threads, tables.typed_data(),
                             tvecs.typed_data(), codes.typed_data(),
                             pidx.typed_data(), starts.typed_data(),
                             lens.typed_data(), xts.typed_data(),
                             alt->typed_data(), nul->typed_data(),
                             scratch->typed_data(), kw);
      break;
    case 8:
      if (threads > 256) return ffi::Error::InvalidArgument("threads > 256");
      err = launch<8, false>(stream, n, threads, tables.typed_data(),
                             tvecs.typed_data(), codes.typed_data(),
                             pidx.typed_data(), starts.typed_data(),
                             lens.typed_data(), xts.typed_data(),
                             alt->typed_data(), nul->typed_data(),
                             scratch->typed_data(), kw);
      break;
    case 16:
      if (threads > 1024) return ffi::Error::InvalidArgument("threads > 1024");
      if (scratch->element_count() < (size_t)(n * 10 * kn))
        return ffi::Error::InvalidArgument("scratch too small");
      err = launch<16, true>(stream, n, threads, tables.typed_data(),
                             tvecs.typed_data(), codes.typed_data(),
                             pidx.typed_data(), starts.typed_data(),
                             lens.typed_data(), xts.typed_data(),
                             alt->typed_data(), nul->typed_data(),
                             scratch->typed_data(), kw);
      break;
    default:
      return ffi::Error::InvalidArgument("nodes_per_thread not in {4, 8, 16}");
  }
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(DeciphonViterbiScore, ScoreImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int64_t>("threads")
                                  .Attr<int64_t>("nodes_per_thread"));
