// Bounce-adjoint kernel for Hopper: one bounce of the hand-written
// record-replay backward. From the recorded winner, texels and the
// bounce's input state it recomputes the replay bounce, chains the
// cotangents to o, d, throughput, time, texels and raw normals, and adds
// the cotangents of the lanes' material, sphere and quad rows and of
// dark_sky onto the running tables of the sweep.
//
// Replaces the TPU kernel tracer/kernels/shade_bwd.py::bounce_bwd_tiles
// (Pallas; body _kernel at shade_bwd.py:37-94, the math of
// tracer/render/replay_bwd.py::bounce_bwd) together with the sweep's
// one-hot matmuls around it (replay_bwd.py:557-566 fetch the rows,
// :639-644 fold the row cotangents into the tables). Here the rows are
// read by index from the small tables, and the row cotangents never leave
// the chip. The plain PyTorch version is
// tracer_torch/kernels/shade_bwd.py::bounce_bwd_plain: the lane math of
// tracer_torch/render/replay_bwd.py::bounce_bwd in the same order (this
// file is built with --fmad=false, so the card reproduces it up to the
// ulp of cosf/sinf under compat=physical), then the one-hot accumulation.
// The tables differ from it only in the order of the f32 sums.
//
// Bound: memory. An active lane reads at most 128 B (st10, j, time, the
// texel record, gpix, the key and the next-state cotangents), a lane that
// is not active its flag and the next-state cotangents, and every lane
// writes a (40 B) and, with the pair atlas, b (24 B): at most ~65-75 MB
// per 408,000-lane launch. Before, every lane also wrote its 45 row
// cotangents (73 MB), which the sweep then folded with three one-hot
// GEMMs of K = 8-19 columns, several times B3's own device time. The
// design, two kernels per call:
// - bounce_bwd_kernel, one wave of persistent blocks of 256 threads, each
//   block walking the tiles of 1024 lanes blockIdx, blockIdx + grid, ...
//   In each tile the block ballots its lanes' active flags and lists the
//   active lanes first, in lane order, in shared memory; its threads then
//   take the list in four rounds of 256, so the adjoint chain runs on
//   full warps of active lanes and the rest write the dead lanes'
//   pass-through (a textured last bounce, 15% active, mixed them in every
//   warp). Each warp then groups its lanes by row id (the first remaining
//   lane's id, a ballot of equal ids; pixels next to each other hit the
//   same primitive, so a warp nearly always holds one material, one
//   sphere and one quad row) and sums each group by a fixed shuffle tree
//   that halves the values at each exchange, the values of non-members
//   set to zero. Lanes whose cotangents are all +-0 for a table join no
//   group (adding them changes no bit). One lane per value adds the sum
//   into the warp's own copy of the tables, in shared memory when the warp
//   copies fit (WARPS x C floats) and in global scratch otherwise. At the
//   end the block sums its warps' copies in warp order into its partial
//   row.
// - bounce_bwd_reduce: each running table entry plus the blocks' partial
//   rows, summed in a fixed order (eight contiguous ranges of blocks, each
//   in block order, then the ranges in order).
// No float atomics: the grid, the tiles of each block and every sum's
// order are fixed, so two runs give the same bits.
//
// Tables: sph [S, 8] (c, r, mb, mid), quad [Q, 19] (v0, er, eu, mb, tan,
// bitan, mid), mat [M, 21] (the 18 matf columns, textype, mtype, mat_nm).
// Inputs [K, n]: st10 = o(3), d(3), tp(3), active; recf = img(3), rnm(3),
// ptex, pnm (read only with the pair atlas: without one the record is all
// zero); gnext = the previous call's a (go2, gd2, gtp2, the running gtm;
// not read on the last bounce, whose next state is dead); gpix (3).
// Running tables acc [C], C = 18M + 8S + 19Q + 1: gmatf [18, M], gsph
// [8, S], gquad [19, Q], gdark, each row-major; the call writes acc_out.
// Outputs: a [10, n] = go(3), gd(3), gtp(3), gtm (the running sum:
// gnext's gtm plus this bounce's); b [6, n] = gimg(3), grnm(3), written
// only with the pair atlas.
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
  const float* recf;   // null without the pair atlas
  const int* key;      // uint32 key bits, salted with the bounce
  const float* tm;
  const float* gnext;  // null on the last bounce
  const float* gpix;
  const float *sph, *quad, *mat;
  const float* acc;
  float *a, *b;        // b null without the pair atlas
  float* part;         // [max_blocks, C] per-block partial tables
  float* wtab;         // [max_blocks, WARPS, C] warp tables (global mode)
  float* acc_out;
};

// Mirror of _Params in tracer_torch/kernels/shade_bwd.py (same order).
struct BwdParams {
  int n, S, Q, M, ref, has_pair, last, smem_tables, max_blocks;
  float eps, n_rem, dark;
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GLASS = 1;
constexpr int MIRROR = 2;
constexpr int TEX_NONE = 0;
constexpr int TEX_CHECKERBOARD = 1;
constexpr int TEX_IMAGE = 2;
// the row cotangents that can be nonzero: matf columns 2-15 and 17
// (texscale and transparency get none), sphere columns 0-6 and quad
// columns 0-17 (the material-id columns get none)
constexpr int NMAT = 15, NSPH = 7, NQUAD = 18;
constexpr int ROUNDS = 4;                // rounds of THREADS lanes a tile
constexpr int SUPER = ROUNDS * THREADS;  // lanes of a tile
constexpr int RGROUPS = 8;               // warps of the reduce kernel

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

// What one active lane's adjoint yields.
struct LaneOut {
  V3 go, gd, gtp, gimg, grnm;
  float gtm, gdark;
  float mat[NMAT], sph[NSPH], quad[NQUAD];
  int js, jq, mid;
};

// The adjoint chain of one active lane i (replay_bwd.bounce_bwd with
// active true).
__device__ __forceinline__ void lane_adjoint(const BwdIO& io,
                                             const BwdParams& p, int i,
                                             V3 go2, V3 gd2, V3 gtp2,
                                             LaneOut& out) {
  const int n = p.n;
  const bool last = p.last != 0;
  const bool ref = p.ref != 0;
  const float* st = io.st10 + i;
  const V3 z3 = {0.0f, 0.0f, 0.0f};
  const V3 gpix = {io.gpix[i], io.gpix[n + i], io.gpix[2 * n + i]};
  const V3 o = {st[0], st[n], st[2 * n]};
  const V3 d = {st[3 * n], st[4 * n], st[5 * n]};
  const V3 tp = {st[6 * n], st[7 * n], st[8 * n]};
  const float tm = io.tm[i];
  V3 img = z3;
  float ptex = 0.0f;
  if (p.has_pair) {
    const float* rf = io.recf + i;
    img = {rf[0], rf[n], rf[2 * n]};
    ptex = rf[6 * n];
  }

  const int j_enc = io.j[i];
  const bool miss = j_enc < 0;
  const int j = j_enc < 0 ? 0 : j_enc;
  const bool live = !miss;
  const bool is_sph = j < p.S;
  const bool is_quad = !is_sph && (j < p.S + p.Q);

  // ---- the lane's rows, read by index ----------------------------------
  out.js = tt::clampi(j, 0, p.S - 1);
  out.jq = tt::clampi(j - p.S, 0, p.Q - 1);
  const float* srow = io.sph + out.js * 8;
  const float* qrow = io.quad + out.jq * 19;
  out.mid = (int)(j < p.S ? srow[7] : qrow[18]);
  const float* mrf = io.mat + tt::clampi(out.mid, 0, p.M - 1) * 21;
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
    const float* rf = io.recf + i;
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
  const bool amiss = miss;
  const V3 g_o2 = mask(live, go2);
  const V3 g_o = mask(!live, go2);
  const V3 g_d2s = mask(live, gd2);
  const V3 g_d = mask(!live, gd2);
  out.gtp = {
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
  out.gdark = -(g_sky.x * (w_sky + a_sky * 0.5f * scale) +
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

  out.gimg = mask(present, g_imgfb);
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
  V3 g_tan = z3, g_bitan = z3, g_n0;
  out.grnm = z3;
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
    out.grnm = {2.0f * g_nmx, 2.0f * g_nmy, 2.0f * g_nmz};
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
  out.go = add(add(g_o, g_o_q), g_o_s);
  out.gd = add(add(add(g_d, g_d_sc), g_d_q), g_d_s);
  out.gd.y = out.gd.y + g_dy_sky;
  out.gtm = g_tm;
  // gmrf columns 2-15, 17: c1, c2, base, lc, intensity, emissive, ior
  const float mv[NMAT] = {g_c1.x,   g_c1.y,   g_c1.z,   g_c2.x, g_c2.y,
                          g_c2.z,   g_base.x, g_base.y, g_base.z, g_lc.x,
                          g_lc.y,   g_lc.z,   gm14,     gm15,   g_ior};
  // gsrow columns 0-6: center, r, mb
  const float sv[NSPH] = {g_tc.x, g_tc.y, g_tc.z, g_r,
                          g_mbs.x, g_mbs.y, g_mbs.z};
  // gqrow columns 0-17: v0, er, eu, mb, tan, bitan
  const float qv2[NQUAD] = {g_v0.x,  g_v0.y,  g_v0.z,  g_er.x,  g_er.y,
                            g_er.z,  g_eu.x,  g_eu.y,  g_eu.z,  g_mbq.x,
                            g_mbq.y, g_mbq.z, g_tan.x, g_tan.y, g_tan.z,
                            g_bitan.x, g_bitan.y, g_bitan.z};
#pragma unroll
  for (int c = 0; c < NMAT; ++c) out.mat[c] = mv[c];
#pragma unroll
  for (int c = 0; c < NSPH; ++c) out.sph[c] = sv[c];
#pragma unroll
  for (int c = 0; c < NQUAD; ++c) out.quad[c] = qv2[c];
}

__host__ __device__ constexpr int ilog2(int k) {
  return k <= 1 ? 0 : 1 + ilog2(k / 2);
}

// Sum the K values v (K a power of two, at most 32) over the lanes of the
// warp by a fixed tree: each exchange sends half of a lane's values and
// keeps the other half, then a butterfly sums the last one. Lane l ends
// with the total of value l >> (5 - log2 K), in 2K - 1 + 5 - log2 K
// shuffles instead of 5K.
template <int K>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[K]) {
  const int lane = threadIdx.x & 31;
  int o = 16;
#pragma unroll
  for (int h = K / 2; h >= 1; h >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, o);
    }
  }
  float x = v[0];
  for (; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// Add the cotangents v[OFF .. OFF + K) of every lane with `in` set to row
// `id` of a row-major [., stride] table `tab` (value c lands in column
// col(c)): lanes are grouped by id (the first remaining lane's id, a
// ballot of equal ids), each group is summed by the fixed tree with the
// values of non-members set to zero (padded to P2 values), and one lane
// per value adds it to the table. Every lane of the warp calls it. Lanes
// whose values are all +-0 join no group: adding them changes no bit.
template <int P2, int OFF, int K, int N, typename Col>
__device__ __forceinline__ void group_add(float* tab, int stride, int id,
                                          bool in, const float (&v)[N],
                                          Col col) {
  static_assert(K <= P2 && P2 <= 32 && (P2 & (P2 - 1)) == 0, "P2");
  static_assert(OFF + K <= N, "OFF + K");
  const int lane = threadIdx.x & 31;
  constexpr int SH = 5 - ilog2(P2);  // lanes per value: 1 << SH
  bool nz = false;
#pragma unroll
  for (int c = 0; c < K; ++c) nz = nz || (v[OFF + c] != 0.0f);  // NaN too
  unsigned todo = __ballot_sync(FULL, in && nz);
  while (todo) {
    const int gid = __shfl_sync(FULL, id, __ffs(todo) - 1);
    const unsigned grp = __ballot_sync(FULL, in && nz && id == gid);
    todo &= ~grp;
    const bool mem = (grp >> lane) & 1u;
    float w[P2];
#pragma unroll
    for (int c = 0; c < P2; ++c)
      w[c] = (c < K && mem) ? v[OFF + (c < K ? c : 0)] : 0.0f;
    const float s = warp_reduce_scatter(w);
    const int c = lane >> SH;
    if ((lane & ((1 << SH) - 1)) == 0 && c < K)
      tab[col(OFF + c) * stride + gid] += s;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
bounce_bwd_kernel(BwdIO io, BwdParams p) {
  extern __shared__ float smem[];
  int* order = reinterpret_cast<int*>(smem);  // [SUPER] lanes, active first
  int* wcnt = order + SUPER;                  // [ROUNDS * WARPS] active
  const int C = 18 * p.M + 8 * p.S + 19 * p.Q + 1;
  float* tabs = p.smem_tables
                    ? smem + SUPER + ROUNDS * WARPS
                    : io.wtab + (size_t)blockIdx.x * WARPS * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* wt = tabs + (size_t)warp * C;
  for (int e = lane; e < C; e += 32) wt[e] = 0.0f;
  __syncwarp();
  float* tmat = wt;
  float* tsph = wt + 18 * p.M;
  float* tquad = tsph + 8 * p.S;
  float* tdark = tquad + 19 * p.Q;

  const int n = p.n;
  const bool last = p.last != 0;
  const int tiles = (n + SUPER - 1) / SUPER;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * SUPER;
    const int nv = min(SUPER, n - t0);
    // list this tile's lanes, the active ones first, each part in lane
    // order (lane r * THREADS + tid is thread tid's in round r)
    bool act[ROUNDS];
    unsigned bal[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const int k = r * THREADS + tid;
      act[r] = k < nv && io.st10[9 * (size_t)n + t0 + k] > 0.5f;
      bal[r] = __ballot_sync(FULL, act[r]);
      if (lane == 0) wcnt[r * WARPS + warp] = __popc(bal[r]);
    }
    __syncthreads();
    int n_act = 0;
    for (int q = 0; q < ROUNDS * WARPS; ++q) n_act += wcnt[q];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      int before = 0;
      for (int q = 0; q < r * WARPS + warp; ++q) before += wcnt[q];
      const int k = r * THREADS + tid;
      const int arank = before + __popc(bal[r] & ((1u << lane) - 1u));
      if (k < nv) order[act[r] ? arank : n_act + k - arank] = k;
    }
    __syncthreads();

    for (int r = 0; r < ROUNDS; ++r) {
      const int slot = r * THREADS + tid;
      if (r * THREADS >= nv) break;  // uniform
      const bool has = slot < nv;
      const int i = has ? t0 + order[slot] : 0;
      const bool active = slot < n_act;
      V3 go2 = {0.0f, 0.0f, 0.0f}, gd2 = go2, gtp2 = go2;
      float gtm0 = 0.0f;
      if (has && !last) {
        const float* gn = io.gnext + i;
        go2 = {gn[0], gn[n], gn[2 * n]};
        gd2 = {gn[3 * n], gn[4 * n], gn[5 * n]};
        gtp2 = {gn[6 * n], gn[7 * n], gn[8 * n]};
        gtm0 = gn[9 * n];
      }
      LaneOut o;
      if (active) {
        lane_adjoint(io, p, i, go2, gd2, gtp2, o);
      } else {  // pass-through: o'=o, d'=d, tp'=tp, no hit, no sky
        o.go = go2;
        o.gd = gd2;
        o.gtp = gtp2;
        o.gtm = 0.0f;
        o.gimg = o.grnm = V3{0.0f, 0.0f, 0.0f};
      }
      if (has) {
        float* A = io.a + i;
        A[0] = o.go.x; A[n] = o.go.y; A[2 * n] = o.go.z;
        A[3 * n] = o.gd.x; A[4 * n] = o.gd.y; A[5 * n] = o.gd.z;
        A[6 * n] = o.gtp.x; A[7 * n] = o.gtp.y; A[8 * n] = o.gtp.z;
        A[9 * n] = last ? o.gtm : (active ? gtm0 + o.gtm : gtm0);
        if (p.has_pair) {
          float* Bo = io.b + i;
          Bo[0] = o.gimg.x; Bo[n] = o.gimg.y; Bo[2 * n] = o.gimg.z;
          Bo[3 * n] = o.grnm.x; Bo[4 * n] = o.grnm.y; Bo[5 * n] = o.grnm.z;
        }
      }
      // the row cotangents of the active lanes onto the warp's tables;
      // the dead lanes' are zero
      if (r * THREADS + warp * 32 < n_act) {  // uniform in the warp
        if (!active) {
#pragma unroll
          for (int c = 0; c < NMAT; ++c) o.mat[c] = 0.0f;
#pragma unroll
          for (int c = 0; c < NSPH; ++c) o.sph[c] = 0.0f;
#pragma unroll
          for (int c = 0; c < NQUAD; ++c) o.quad[c] = 0.0f;
          o.gdark = 0.0f;
          o.js = o.jq = o.mid = 0;
        }
        // the plain one-hot product drops a material id outside [0, M)
        const auto same = [](int c) { return c; };
        group_add<16, 0, NMAT>(
            tmat, p.M, o.mid, active && o.mid >= 0 && o.mid < p.M, o.mat,
            [](int c) { return c < 14 ? c + 2 : 17; });
        group_add<8, 0, NSPH>(tsph, p.S, o.js, active, o.sph, same);
        // the quad row in two parts: 16 + 2 values pad to fewer than 32
        group_add<16, 0, 16>(tquad, p.Q, o.jq, active, o.quad, same);
        group_add<2, 16, 2>(tquad, p.Q, o.jq, active, o.quad, same);
        const float dk[1] = {o.gdark};
        group_add<1, 0, 1>(tdark, 1, 0, active, dk, same);
      }
    }
    __syncthreads();  // the next tile rewrites order and wcnt
  }
  // the block's partial row: its warps' tables summed in warp order
  float* part = io.part + (size_t)blockIdx.x * C;
  for (int e = tid; e < C; e += THREADS) {
    float s = tabs[e];
    for (int w = 1; w < WARPS; ++w) s = s + tabs[(size_t)w * C + e];
    part[e] = s;
  }
}

// acc_out[e] = acc[e] + the blocks' partial rows: 32 entries a block, its
// RGROUPS warps each summing a contiguous range of partial rows in order,
// then the ranges in order
__global__ void __launch_bounds__(32 * RGROUPS)
bounce_bwd_reduce(const float* acc, const float* part, float* acc_out,
                  int C, int blocks) {
  __shared__ float sums[RGROUPS][32];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int per = (blocks + RGROUPS - 1) / RGROUPS;
  const int lo = min(blocks, g * per), hi = min(blocks, lo + per);
  float s = 0.0f;
  if (e < C && lo < hi) {
    s = part[(size_t)lo * C + e];
    for (int b = lo + 1; b < hi; ++b) s = s + part[(size_t)b * C + e];
  }
  sums[g][lane] = s;
  __syncthreads();
  if (g == 0 && e < C) {
    float t = sums[0][lane];
    for (int q = 1; q < RGROUPS; ++q)
      if (q * per < blocks) t = t + sums[q][lane];
    acc_out[e] = acc[e] + t;
  }
}

}  // namespace

extern "C" int tt_bounce_bwd(const BwdIO* io, const BwdParams* prm,
                             void* stream) {
  const BwdParams p = *prm;
  cudaStream_t s = (cudaStream_t)stream;
  if (p.n <= 0) return 0;
  const int C = 18 * p.M + 8 * p.S + 19 * p.Q + 1;
  // the wrapper keeps the warp tables in shared memory only below 48 KB
  const size_t smem = sizeof(int) * (SUPER + ROUNDS * WARPS) +
                      (p.smem_tables ? sizeof(float) * WARPS * C : 0);
  // one wave of blocks, at most max_blocks (the scratch's rows) and at
  // most one per tile
  // (the device's wave for the last shared-memory size, kept: the
  // occupancy query costs more host time than the launch)
  static int last_dev = -1, sms = 0, per_sm = 0;
  static size_t last_smem = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != last_dev || smem != last_smem) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bounce_bwd_kernel, THREADS, smem);
    last_dev = dev;
    last_smem = smem;
  }
  const int tiles = (p.n + SUPER - 1) / SUPER;
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  blocks = blocks < p.max_blocks ? blocks : p.max_blocks;
  blocks = blocks < tiles ? blocks : tiles;
  if (blocks < 1) blocks = 1;
  bounce_bwd_kernel<<<blocks, THREADS, smem, s>>>(*io, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bounce_bwd_reduce<<<(C + 31) / 32, 32 * RGROUPS, 0, s>>>(
      io->acc, io->part, io->acc_out, C, blocks);
  return (int)cudaGetLastError();
}
