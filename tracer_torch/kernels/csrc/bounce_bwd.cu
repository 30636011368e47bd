// Bounce-adjoint kernel for Hopper: one bounce of the hand-written
// record-replay backward, one thread per lane. From the recorded winner,
// texels and the bounce's input state it recomputes the replay bounce and
// chains the cotangents to o, d, throughput, time, texels, raw normals,
// dark_sky and the lane's material, sphere and quad rows.
//
// Replaces the TPU kernel tracer/kernels/shade_bwd.py::bounce_bwd_tiles
// (Pallas; body _kernel at shade_bwd.py:37-94, the math of
// tracer/render/replay_bwd.py::bounce_bwd). The TPU path fed it per-lane
// material/sphere/quad rows fetched by one-hot matmuls in XLA
// (replay_bwd.py:557-566); here the rows are read by index from the small
// tables. The plain PyTorch version is
// tracer_torch/kernels/shade_bwd.py::bounce_bwd_plain
// (tracer_torch/render/replay_bwd.py::bounce_bwd): the same expressions in
// the same order, and this file is built with --fmad=false, so the card
// reproduces it up to the ulp of cosf/sinf under compat=physical.
//
// Bound: memory. An active lane reads at most 132 B (st10, j, recf, key,
// time, gcar) and every lane writes 248 B (a, b, c): at most ~155 MB per
// 408,000-lane launch, ~46 us at 3.35 TB/s. The arithmetic is a few
// hundred flops per lane, far below the compute bound. Every intermediate
// stays in registers; each input is read once, only where the result
// needs it, and each output written once. A lane that is not active reads
// its active flag and the next-state cotangents and takes an early exit
// that writes the pass-through (go = go2, gd = gd2, gtp = gtp2, zeros
// elsewhere), as the TPU kernel's dead tile. The last bounce reads no
// next-state cotangent and no key, and a scene without an atlas reads no
// normal-map record. A warp that mixes active and inactive lanes issues
// both branches' stores (PERF.md has what that costs, and what one common
// store path cost the fully active bounces instead).
//
// Tables: sph [S, 8] (c, r, mb, mid), quad [Q, 19] (v0, er, eu, mb, tan,
// bitan, mid), mat [M, 21] (the 18 matf columns, textype, mtype, mat_nm).
// Inputs [K, n]: st10 = o(3), d(3), tp(3), active; recf = img(3), rnm(3),
// ptex, pnm; gcar = go2(3), gd2(3), gtp2(3), gpix(3).
// Outputs: a [11, n] = go(3), gd(3), gtp(3), gtm, gdark;
//          b [6, n] = gimg(3), grnm(3);
//          c [45, n] = gmrf(18), gsrow(8), gqrow(19).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf.cuh"
#include "common.cuh"
#include "pcg.cuh"

// Mirror of _IO in tracer_torch/kernels/shade_bwd.py (same order).
struct BwdIO {
  const float* st10;
  const int* j;
  const float* recf;
  const int* key;  // uint32 key bits, salted with the bounce
  const float* tm;
  const float* gcar;
  const float *sph, *quad, *mat;
  float *a, *b, *c;
};

// Mirror of _Params in tracer_torch/kernels/shade_bwd.py (same order).
struct BwdParams {
  int n, S, Q, M, ref, has_pair, last;
  float eps, n_rem, dark;
};

namespace {

constexpr int THREADS = 128;
constexpr int GLASS = 1;
constexpr int MIRROR = 2;
constexpr int TEX_NONE = 0;
constexpr int TEX_CHECKERBOARD = 1;
constexpr int TEX_IMAGE = 2;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 sc(float k, V3 a) {
  return {k * a.x, k * a.y, k * a.z};
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 wh(bool m, V3 a, V3 b) { return m ? a : b; }
__device__ __forceinline__ V3 mask(bool m, V3 a) {
  return m ? a : V3{0.0f, 0.0f, 0.0f};
}
__device__ __forceinline__ float mk(bool m, float a) { return m ? a : 0.0f; }

// vec3p.normalize forward: unit, inv and the differentiable-branch flag
struct Norm {
  V3 u;
  float inv;
  bool sel;
};
__device__ __forceinline__ Norm norm_fwd(V3 v) {
  float s = sqrtf(dot(v, v));
  float inv = 1.0f / tt::maxf(s, 1e-20f);
  return {sc(inv, v), inv, s >= 1e-20f};
}
// adjoint of u = v / max(|v|, eps): gv = inv*(g - sel*u*(u.g))
__device__ __forceinline__ V3 norm_bwd(Norm nf, V3 g) {
  float k = nf.sel ? dot(nf.u, g) : 0.0f;
  return {nf.inv * (g.x - nf.u.x * k), nf.inv * (g.y - nf.u.y * k),
          nf.inv * (g.z - nf.u.z * k)};
}

__global__ void __launch_bounds__(THREADS)
bounce_bwd_kernel(BwdIO io, BwdParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int n = p.n;
  const bool last = p.last != 0;
  const bool ref = p.ref != 0;
  const float* st = io.st10 + i;
  const float* gc = io.gcar + i;
  float* A = io.a + i;
  float* Bo = io.b + i;
  float* C = io.c + i;
  const V3 z3 = {0.0f, 0.0f, 0.0f};
  V3 go2 = z3, gd2 = z3, gtp2 = z3;  // the last bounce's next state is dead
  if (!last) {
    go2 = {gc[0], gc[n], gc[2 * n]};
    gd2 = {gc[3 * n], gc[4 * n], gc[5 * n]};
    gtp2 = {gc[6 * n], gc[7 * n], gc[8 * n]};
  }
  const bool active = st[9 * n] > 0.5f;

  if (!active) {  // pass-through: o'=o, d'=d, tp'=tp, no hit, no sky
    A[0] = go2.x; A[n] = go2.y; A[2 * n] = go2.z;
    A[3 * n] = gd2.x; A[4 * n] = gd2.y; A[5 * n] = gd2.z;
    A[6 * n] = gtp2.x; A[7 * n] = gtp2.y; A[8 * n] = gtp2.z;
    A[9 * n] = 0.0f;
    A[10 * n] = 0.0f;
    for (int k = 0; k < 6; ++k) Bo[k * n] = 0.0f;
    for (int k = 0; k < 45; ++k) C[k * n] = 0.0f;
    return;
  }

  const V3 gpix = {gc[9 * n], gc[10 * n], gc[11 * n]};
  const V3 o = {st[0], st[n], st[2 * n]};
  const V3 d = {st[3 * n], st[4 * n], st[5 * n]};
  const V3 tp = {st[6 * n], st[7 * n], st[8 * n]};
  const float tm = io.tm[i];
  const float* rf = io.recf + i;
  const V3 img = {rf[0], rf[n], rf[2 * n]};
  const float ptex = rf[6 * n];

  const int j_enc = io.j[i];
  const bool miss = j_enc < 0;
  const int j = j_enc < 0 ? 0 : j_enc;
  const bool live = active && !miss;
  const bool is_sph = j < p.S;
  const bool is_quad = !is_sph && (j < p.S + p.Q);

  // ---- the lane's rows, read by index ----------------------------------
  const float* srow = io.sph + tt::clampi(j, 0, p.S - 1) * 8;
  const float* qrow = io.quad + tt::clampi(j - p.S, 0, p.Q - 1) * 19;
  const int mid = (int)(j < p.S ? srow[7] : qrow[18]);
  const float* mrf = io.mat + tt::clampi(mid, 0, p.M - 1) * 21;
  const int textype = (int)mrf[18];
  const int mtype = (int)mrf[19];
  const int use_nm = (int)mrf[20];

  // ================= primal recompute (what the adjoint needs) ==========
  const float a2 = dot(d, d);

  // sphere detail
  const V3 center = {srow[0], srow[1], srow[2]};
  const float radius = srow[3];
  const V3 mb_s = {srow[4], srow[5], srow[6]};
  const V3 tc = add(center, sc(tm, mb_s));
  const V3 oc = sub(o, tc);
  const float b_s = 2.0f * dot(d, oc);
  const float c_s = dot(oc, oc) - radius * radius;
  const float delta = b_s * b_s - 4.0f * a2 * c_s;
  const float sq = sqrtf(tt::maxf(delta, 1e-12f));
  const float t_s = (-b_s - sq) / (2.0f * a2);
  const V3 p_s = add(o, sc(t_s, d));
  const V3 vns = sub(p_s, tc);
  const Norm ns = norm_fwd(vns);

  // quad detail
  const V3 v0 = {qrow[0], qrow[1], qrow[2]};
  const V3 er = {qrow[3], qrow[4], qrow[5]};
  const V3 eu = {qrow[6], qrow[7], qrow[8]};
  const V3 mb_q = {qrow[9], qrow[10], qrow[11]};
  const V3 tan = {qrow[12], qrow[13], qrow[14]};
  const V3 bitan = {qrow[15], qrow[16], qrow[17]};
  const V3 cr = cross(er, eu);
  const Norm nq = norm_fwd(cr);
  const V3 n_q = nq.u;
  const V3 bl = add(v0, sc(tm, mb_q));
  const float dotRN = dot(d, n_q);
  const float safe =
      fabsf(dotRN) < 1e-9f ? (dotRN < 0.0f ? -1e-9f : 1e-9f) : dotRN;
  const float num_q = dot(bl, n_q) - dot(o, n_q);
  const float t_q = num_q / safe;
  const V3 p_q = add(o, sc(t_q, d));
  const V3 qv = sub(p_q, bl);
  const float u_q = dot(qv, er) / tt::maxf(dot(er, er), 1e-30f);
  const float v_q = dot(qv, eu) / tt::maxf(dot(eu, eu), 1e-30f);

  const V3 n0 = wh(is_quad, n_q, ns.u);

  // material fields (matf layout)
  const float sx = mrf[0], sy = mrf[1];
  const V3 c1 = {mrf[2], mrf[3], mrf[4]};
  const V3 c2 = {mrf[5], mrf[6], mrf[7]};
  const V3 base = {mrf[8], mrf[9], mrf[10]};
  const V3 lc = {mrf[11], mrf[12], mrf[13]};
  const float intens = mrf[14], emsv = mrf[15], ior = mrf[17];

  // texture selects
  const bool same = tt::trunc_mod2(u_q * sx) == tt::trunc_mod2(v_q * sy);
  const V3 checker = wh(same, c1, c2);
  const bool same8 =
      tt::trunc_mod2(u_q * 8.0f) == tt::trunc_mod2(v_q * 8.0f);
  const float on = same8 ? 0.0f : 1.0f;
  const V3 magenta = {on, 0.0f, on};
  const bool present = ptex > 0.5f;
  const V3 img_fb = wh(present, img, magenta);
  const bool is_chk = textype == TEX_CHECKERBOARD;
  const bool is_img = textype == TEX_IMAGE;
  const bool is_none = textype == TEX_NONE;
  const V3 textured = wh(is_chk, checker, base);
  const V3 diffuse = wh(is_img, img_fb, textured);

  // normal mapping (quads only)
  V3 nmv = z3;
  Norm n2 = {z3, 0.0f, false};
  bool upd = false;
  V3 nrm = n0;
  if (p.has_pair) {
    const V3 rnm = {rf[3 * n], rf[4 * n], rf[5 * n]};
    const float pnm = rf[7 * n];
    nmv = {2.0f * rnm.x - 1.0f, 2.0f * rnm.y - 1.0f, 2.0f * rnm.z - 1.0f};
    const V3 v2 = {nmv.x * tan.x + nmv.y * bitan.x + nmv.z * n0.x,
                   nmv.x * tan.y + nmv.y * bitan.y + nmv.z * n0.y,
                   nmv.x * tan.z + nmv.y * bitan.z + nmv.z * n0.z};
    n2 = norm_fwd(v2);
    upd = is_quad && (pnm > 0.5f) && (use_nm > 0);
    nrm = wh(upd, n2.u, n0);
  }

  // emission
  V3 etex = wh(is_chk, checker, lc);
  etex = wh(is_img, img_fb, etex);
  const V3 ecol = wh(is_none, lc, etex);
  const float kem = intens * emsv;
  const V3 emis = sc(kem, ecol);

  // procedural sky
  const float a_sky = 0.5f * (d.y + 1.0f);
  const float scale = ref ? (p.n_rem + 1.0f) : 1.0f;
  const float w_sky = 1.0f - a_sky;
  const float k_sky = 1.0f - p.dark;
  const V3 sky = {k_sky * (w_sky + a_sky * 0.5f * scale),
                  k_sky * (w_sky + a_sky * 0.7f * scale),
                  k_sky * (w_sky + a_sky * 1.0f * scale)};

  // ================= adjoint (reverse order) ============================
  const bool amiss = active && miss;
  const V3 g_o2 = mask(live, go2);
  const V3 g_o = mask(!live, go2);
  const V3 g_d2s = mask(live, gd2);
  const V3 g_d = mask(!live, gd2);
  const V3 g_tp = {
      (live ? gtp2.x * diffuse.x : gtp2.x) + mk(amiss, gpix.x * sky.x) +
          mk(live, gpix.x * emis.x),
      (live ? gtp2.y * diffuse.y : gtp2.y) + mk(amiss, gpix.y * sky.y) +
          mk(live, gpix.y * emis.y),
      (live ? gtp2.z * diffuse.z : gtp2.z) + mk(amiss, gpix.z * sky.z) +
          mk(live, gpix.z * emis.z)};
  const V3 g_diffuse =
      mask(live, {gtp2.x * tp.x, gtp2.y * tp.y, gtp2.z * tp.z});
  const V3 g_sky = mask(amiss, {gpix.x * tp.x, gpix.y * tp.y, gpix.z * tp.z});
  const V3 g_emis =
      mask(live, {gpix.x * tp.x, gpix.y * tp.y, gpix.z * tp.z});

  // sky: d/d(a) of comp c = k*(coef_c*scale - 1); d(a)/d(dy) = 0.5
  const float g_a = g_sky.x * k_sky * (0.5f * scale - 1.0f) +
                    g_sky.y * k_sky * (0.7f * scale - 1.0f) +
                    g_sky.z * k_sky * (1.0f * scale - 1.0f);
  const float g_dy_sky = 0.5f * g_a;
  const float g_dark = -(g_sky.x * (w_sky + a_sky * 0.5f * scale) +
                         g_sky.y * (w_sky + a_sky * 0.7f * scale) +
                         g_sky.z * (w_sky + a_sky * 1.0f * scale));

  // emission: emis = kem * ecol
  const float g_kem =
      g_emis.x * ecol.x + g_emis.y * ecol.y + g_emis.z * ecol.z;
  const V3 g_ecol = sc(kem, g_emis);
  const float gm14 = g_kem * emsv;
  const float gm15 = g_kem * intens;
  const bool m_img_e = !is_none && is_img;
  const bool m_chk_e = !is_none && !is_img && is_chk;
  const bool m_lc_e = is_none || (!is_img && !is_chk);
  V3 g_imgfb = mask(m_img_e, g_ecol);
  V3 g_checker = mask(m_chk_e, g_ecol);
  const V3 g_lc = mask(m_lc_e, g_ecol);

  // diffuse: wh(is_img, img_fb, wh(is_chk, checker, base))
  const bool m_chk_d = !is_img && is_chk;
  const bool m_base = !is_img && !is_chk;
  g_imgfb = add(g_imgfb, mask(is_img, g_diffuse));
  g_checker = add(g_checker, mask(m_chk_d, g_diffuse));
  const V3 g_base = mask(m_base, g_diffuse);

  const V3 gimg = mask(present, g_imgfb);
  const V3 g_c1 = mask(same, g_checker);
  const V3 g_c2 = mask(!same, g_checker);

  // ---------- scatter adjoint (dead on the last bounce) ----------
  V3 g_n = z3, g_p = z3, g_d_sc = z3;
  float g_ior = 0.0f;
  if (!last) {
    const uint32_t bk = (uint32_t)io.key[i];
    const float ddn = dot(d, nrm);
    const tt::GlassLobe lobe = tt::glass_lobe(ddn, ior, ref, bk);
    const float ri = lobe.ri;
    const bool use_reflect = lobe.reflect;
    const float kr = 2.0f * ddn;
    const V3 rfl = sub(d, sc(kr, nrm));
    const float cth = tt::minf(ddn, 1.0f);
    const V3 pp = {ri * (cth * nrm.x + d.x), ri * (cth * nrm.y + d.y),
                   ri * (cth * nrm.z + d.z)};
    const float kkw = 1.0f - dot(pp, pp);
    const float kk = fabsf(kkw);
    const float m_r = tt::maxf(kk, 1e-12f);
    const float sqm = sqrtf(m_r);
    const float par = -sqm;
    const V3 rr = add(sc(par, nrm), pp);
    V3 ruv;
    tt::scatter_sample(bk, ref, &ruv.x, &ruv.y, &ruv.z);
    const V3 ddf0 = add(nrm, ruv);
    const bool tinyn = sqrtf(dot(ddf0, ddf0)) <= p.eps;
    const bool is_g = mtype == GLASS;
    const bool is_m = mtype == MIRROR;
    const V3 d_glass = wh(use_reflect, rfl, rr);
    const V3 ddf = wh(tinyn, nrm, ddf0);
    const V3 v_lobe = wh(is_g, d_glass, wh(is_m, rfl, ddf));
    const Norm d2 = norm_fwd(v_lobe);

    // reverse: o2 = p + eps*d2
    g_p = g_o2;
    const V3 g_d2 = add(g_d2s, sc(p.eps, g_o2));
    const V3 g_v = norm_bwd(d2, g_d2);
    const V3 g_dglass = mask(is_g, g_v);
    V3 g_rf = mask(is_m && !is_g, g_v);
    const V3 g_ddf = mask(!is_g && !is_m, g_v);
    g_n = g_ddf;  // ddf = wh(tiny, n, n + ruv): both branches pass to n
    g_rf = add(g_rf, mask(use_reflect, g_dglass));
    const V3 g_rr = mask(!use_reflect, g_dglass);
    // rr = par*n + pp
    const float g_par = dot(nrm, g_rr);
    g_n = add(g_n, sc(par, g_rr));
    V3 g_pp = g_rr;
    // par = -sqrt(max(|kkw|, 1e-12))
    const float g_m = -0.5f / sqm * g_par;
    const float g_kk = kk >= 1e-12f ? g_m : 0.0f;
    const float g_kkw = kkw > 0.0f ? g_kk : (kkw < 0.0f ? -g_kk : 0.0f);
    g_pp = {g_pp.x + -2.0f * pp.x * g_kkw, g_pp.y + -2.0f * pp.y * g_kkw,
            g_pp.z + -2.0f * pp.z * g_kkw};
    // pp = ri*(cth*n + d)
    const float g_ri = g_pp.x * (cth * nrm.x + d.x) +
                       g_pp.y * (cth * nrm.y + d.y) +
                       g_pp.z * (cth * nrm.z + d.z);
    const float g_cth = ri * dot(nrm, g_pp);
    g_n = {g_n.x + ri * cth * g_pp.x, g_n.y + ri * cth * g_pp.y,
           g_n.z + ri * cth * g_pp.z};
    g_d_sc = {g_d_sc.x + ri * g_pp.x, g_d_sc.y + ri * g_pp.y,
              g_d_sc.z + ri * g_pp.z};
    float g_ddn = ddn <= 1.0f ? g_cth : 0.0f;
    // rf = d - kr*n ; kr = 2*ddn
    const float g_kr = -dot(nrm, g_rf);
    g_d_sc = add(g_d_sc, g_rf);
    g_n = {g_n.x + -kr * g_rf.x, g_n.y + -kr * g_rf.y, g_n.z + -kr * g_rf.z};
    g_ddn = g_ddn + 2.0f * g_kr;
    // ri select (+ 1/iw)
    float g_iorinv;
    if (ref) {
      g_iorinv = lobe.going_out ? g_ri : 0.0f;
      g_ior = lobe.going_out ? 0.0f : g_ri;
    } else {
      g_ior = lobe.going_out ? g_ri : 0.0f;
      g_iorinv = lobe.going_out ? 0.0f : g_ri;
    }
    const float g_iw = -g_iorinv * lobe.ior_inv * lobe.ior_inv;
    g_ior = g_ior + (ior > 1e-12f ? g_iw : 0.0f);
    // ddn = d.n
    g_d_sc = add(g_d_sc, sc(g_ddn, nrm));
    g_n = add(g_n, sc(g_ddn, d));
  }

  // ---------- normal-map adjoint ----------
  V3 grnm = z3, g_tan = z3, g_bitan = z3, g_n0;
  if (p.has_pair) {
    const V3 g_n2 = mask(upd, g_n);
    g_n0 = mask(!upd, g_n);
    const V3 g_v2 = norm_bwd(n2, g_n2);
    const float g_nmx = dot(tan, g_v2);
    const float g_nmy = dot(bitan, g_v2);
    const float g_nmz = dot(n0, g_v2);
    g_tan = sc(nmv.x, g_v2);
    g_bitan = sc(nmv.y, g_v2);
    g_n0 = add(g_n0, sc(nmv.z, g_v2));
    grnm = {2.0f * g_nmx, 2.0f * g_nmy, 2.0f * g_nmz};
  } else {
    g_n0 = g_n;
  }

  // ---------- p / n selects ----------
  const V3 g_pq = mask(is_quad, g_p);
  V3 g_ps = mask(!is_quad, g_p);
  V3 g_nq = mask(is_quad, g_n0);
  const V3 g_ns = mask(!is_quad, g_n0);

  // ---------- quad detail adjoint ----------
  V3 g_o_q = g_pq;
  const float g_tq = dot(g_pq, d);
  V3 g_d_q = sc(t_q, g_pq);
  const float g_num = g_tq / safe;
  const float g_safe = -t_q * g_tq / safe;
  const float g_dotRN = fabsf(dotRN) >= 1e-9f ? g_safe : 0.0f;
  const V3 g_bl = sc(g_num, n_q);
  g_o_q = {g_o_q.x + -g_num * n_q.x, g_o_q.y + -g_num * n_q.y,
           g_o_q.z + -g_num * n_q.z};
  g_nq = {g_nq.x + g_num * (bl.x - o.x), g_nq.y + g_num * (bl.y - o.y),
          g_nq.z + g_num * (bl.z - o.z)};
  g_d_q = add(g_d_q, sc(g_dotRN, n_q));
  g_nq = add(g_nq, sc(g_dotRN, d));
  const V3 g_cr = norm_bwd(nq, g_nq);
  const V3 g_er = cross(eu, g_cr);
  const V3 g_eu = cross(g_cr, er);
  const V3 g_v0 = g_bl;
  float g_tm = is_quad ? dot(g_bl, mb_q) : 0.0f;
  const V3 g_mbq = sc(tm, g_bl);

  // ---------- sphere detail adjoint ----------
  const V3 g_vns = norm_bwd(ns, g_ns);
  g_ps = add(g_ps, g_vns);
  V3 g_tc = sc(-1.0f, g_vns);
  V3 g_o_s = g_ps;
  const float g_ts = dot(g_ps, d);
  V3 g_d_s = sc(t_s, g_ps);
  const float inv2a2 = 1.0f / (2.0f * a2);
  float g_b = -g_ts * inv2a2;
  const float g_sq = -g_ts * inv2a2;
  float g_a2 = -t_s * g_ts / a2;
  const float g_delta = delta >= 1e-12f ? g_sq * 0.5f / sq : 0.0f;
  g_b = g_b + 2.0f * b_s * g_delta;
  g_a2 = g_a2 + -4.0f * c_s * g_delta;
  const float g_c = -4.0f * a2 * g_delta;
  V3 g_oc = sc(2.0f * g_c, oc);
  const float g_r = -2.0f * radius * g_c;
  g_d_s = add(g_d_s, sc(2.0f * g_b, oc));
  g_oc = add(g_oc, sc(2.0f * g_b, d));
  g_o_s = add(g_o_s, g_oc);
  g_tc = {g_tc.x + -g_oc.x, g_tc.y + -g_oc.y, g_tc.z + -g_oc.z};
  g_tm = g_tm + (is_sph ? dot(g_tc, mb_s) : 0.0f);
  const V3 g_mbs = sc(tm, g_tc);
  g_d_s = add(g_d_s, sc(2.0f * g_a2, d));

  // ---------- totals ----------
  const V3 go = add(add(g_o, g_o_q), g_o_s);
  V3 gd = add(add(add(g_d, g_d_sc), g_d_q), g_d_s);
  gd.y = gd.y + g_dy_sky;

  A[0] = go.x; A[n] = go.y; A[2 * n] = go.z;
  A[3 * n] = gd.x; A[4 * n] = gd.y; A[5 * n] = gd.z;
  A[6 * n] = g_tp.x; A[7 * n] = g_tp.y; A[8 * n] = g_tp.z;
  A[9 * n] = g_tm;
  A[10 * n] = g_dark;
  Bo[0] = gimg.x; Bo[n] = gimg.y; Bo[2 * n] = gimg.z;
  Bo[3 * n] = grnm.x; Bo[4 * n] = grnm.y; Bo[5 * n] = grnm.z;
  // gmrf: texscale(2) = 0, c1, c2, base, lc, intensity, emissive,
  // transparency = 0, ior
  const float cm[45] = {
      0.0f, 0.0f, g_c1.x, g_c1.y, g_c1.z, g_c2.x, g_c2.y, g_c2.z,
      g_base.x, g_base.y, g_base.z, g_lc.x, g_lc.y, g_lc.z, gm14, gm15,
      0.0f, g_ior,
      // gsrow: center, r, mb, mid = 0
      g_tc.x, g_tc.y, g_tc.z, g_r, g_mbs.x, g_mbs.y, g_mbs.z, 0.0f,
      // gqrow: v0, er, eu, mb, tan, bitan, mid = 0
      g_v0.x, g_v0.y, g_v0.z, g_er.x, g_er.y, g_er.z, g_eu.x, g_eu.y,
      g_eu.z, g_mbq.x, g_mbq.y, g_mbq.z, g_tan.x, g_tan.y, g_tan.z,
      g_bitan.x, g_bitan.y, g_bitan.z, 0.0f};
#pragma unroll
  for (int k = 0; k < 45; ++k) C[k * n] = cm[k];
}

}  // namespace

extern "C" int tt_bounce_bwd(const BwdIO* io, const BwdParams* prm,
                             void* stream) {
  const int blocks = (prm->n + THREADS - 1) / THREADS;
  bounce_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*io, *prm);
  return (int)cudaGetLastError();
}
