// First-hit kernel for Hopper: closest hit over all spheres, quads and the
// meshes' BVH hits, then the winner's hit detail, for the live lanes of a
// ray batch.
//
// Replaces the TPU kernel tracer/kernels/intersect.py::first_hits (Pallas;
// body _kernel at intersect.py:122-379). The plain PyTorch version is
// tracer_torch/kernels/intersect.py::first_hits_plain; both follow the
// TPU kernel's expressions, and this file is built with --fmad=false, so
// the card reproduces the plain version bit for bit on live lanes.
//
// Bound. At bounce 0 of the flagship (408,000 live lanes) a lane reads 29 B
// and writes 52 B, ~33 MB or 10 us at the card's memory rate; but the
// candidate loop over 2 spheres and 11 quads (an IEEE division per quad, a
// square root and a division per sphere, ~90 instructions a quad) makes the
// kernel issue-bound on a dense bounce: ~30 us at every bounce of the flat
// box on an H100 for the first port. The SIMD form carried over from the
// TPU kernel paid for every lane the same: a dead lane wrote all 21
// outputs, a live lane ran every division and square root and the detail
// of both a sphere and a quad winner, and with 15% of the lanes live and
// scattered, nearly every warp ran the whole chain. The design:
// - persistent blocks (lanes.cuh) load the tables once into dynamic shared
//   memory and walk tiles of 256 lanes; each tile lists its live lanes in
//   shared memory, so a warp runs 32 live lanes (tiles of 1,024 lanes
//   filled more warps on sparse bounces, but on an H100 they cost the
//   flat box's dense protocol step ~4%: fewer lanes in flight);
// - a dead lane costs its live flag and the integer fields a consumer
//   indexes with (j = tid = -1, mid = row = sub [= idx_t = idx_n] = 0); its
//   float fields are not written (no consumer reads them: B2 returns on an
//   inactive lane, B6 is masked by active & j >= 0, the record and B3 read
//   only j, tid and the texel indices of a dead lane);
// - exact rejections before the divisions and square roots, by IEEE sign
//   rules: a sphere is out when its valid flag is off, b >= 0 (then
//   -b - sqrt(delta) <= 0, so t <= 0 < eps), delta < 0, or -b - sqrt(delta)
//   <= 0; a quad when it is not valid, faces away and is not glass,
//   dotRN == 0, or (D - o.n) and dotRN differ in sign or the numerator is
//   zero (then t <= 0 < eps); a quad's t >= best fails before its
//   in-bounds tests. They pay where a warp's lanes agree: a warp whose rays
//   share a direction octant (camera rays) takes the loop with them (on an
//   H100, the flat box's bounce 0: ~30 -> ~24 us), any other the loop
//   without, since on incoherent bounces the early exits diverged and
//   cost more than they saved (warp votes cost more still). The full test
//   decides every lane either way, on the same values as the SIMD form,
//   so the winner is the same. They hold only for eps > 0 (a t of -0
//   passes t >= eps at eps = 0), so a call with eps <= 0 takes the loop
//   without them;
// - only the winner's detail, by a branch: a quad's, a mesh's, or a
//   sphere's (also for no winner, from a zero row, as the SIMD form's
//   zeroed cache gives); a non-quad winner gets u = v = 0, as there;
// - a slim record: the tangent frame and the pair-atlas masks (ptex, pnm)
//   are per-quad constants that B2 and B3 read from the quad table by j,
//   so the kernel writes p, n, u, v and the integer fields only: 52 B a
//   live lane (with tex_out = 2, 60 B), not 84;
// - the tables sit in shared memory with rows padded to whole float4s (a
//   quad's candidate test makes seven 16-byte loads, not 19 of 4); tables
//   beyond the block's 227 KB are read through L2 (__ldg) by the kernel's
//   second instance.
//
// Textured spheres (sphere_uv, with tex_out >= 1): a sphere winner gets
// the texture coordinates of Sphere.h:130, u = phi / (2 pi), v = theta / pi
// with theta = acos(clip(-n_y, -1 + 1e-7, 1 - 1e-7)) and phi = atan2(-n_z,
// n_x + 1e-20) + pi, and the texel fields of a quad winner from its
// material's row of sph_tex [S, 15] (the quad table's columns 32-46, in
// that order; tracer_torch/kernels/intersect.py::sphere_tex_table), read
// once per sphere winner through the read-only cache. The JAX package
// computes these in XLA after its kernel (tracer/render/integrator.py:
// 804-850), since Mosaic has no acos or atan2.
//
// Meshes (after the spheres and quads, in mesh order): the BVH walk's
// closest raw hit t_mesh[m] is a candidate when >= eps (Scene.h:224), and
// a mesh winner's triangle tri_mesh[m] comes out as tid. A mesh winner's p
// and n are its triangle hit detail (mesh.cuh) from the mesh pack row of
// tid; its u, v and texel fields are 0.
//
// Table layouts (tracer_torch/kernels/intersect.py::intersect_tables):
//   sph  [S, 9]:  0:3 c, 3 r, 4:7 mb, 7 valid, 8 midf
//   quad [Q, 47]: 0:3 v0, 3:6 er, 6:9 eu, 9:12 n, 12:15 mb, 15 v0.n,
//     16 mb.n, 17 v0.er, 18 mb.er, 19 v0.eu, 20 mb.eu, 21 er.er, 22 eu.eu,
//     23 glass, 24 valid, 25 midf, 26:29 tan, 29:32 bitan, 32 sx, 33 sy,
//     34 pair_wa, 35 pair_ha, 36 pair_wb, 37 pair_hb, 38 pair_off,
//     39 pair_tex, 40 pair_nm, 41 tex_off, 42 tex_w, 43 tex_h, 44 nm_off,
//     45 nm_w, 46 nm_h (the true-atlas dims, read with tex_out=2)
// Outputs: out_i [5, n] = j, tid, mid, row, sub, and with tex_out=2
//            [7, n] = ... idx_t, idx_n (true atlas indices, the record
//            forward's texel-cotangent fold; 0 unless a quad wins, or
//            with sphere_uv a sphere);
//          out_f [8, n] = p(3), n(3), u, v (live lanes only).
// Mesh inputs: t_mesh [Nm, n] f32, tri_mesh [Nm, n] i32, mesh_mid [Nm] f32
// (the meshes' material ids), pack [T, 24] (intersect.py::mesh_tables).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "lanes.cuh"
#include "mesh.cuh"

// Mirror of _Args in tracer_torch/kernels/intersect.py (same order).
struct FirstHitsArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  const unsigned char* live;
  const float *sph, *quad;
  const float* t_mesh;
  const int* tri_mesh;
  const float *mesh_mid, *pack;
  const float* sph_tex;  // textured spheres: [S, 15] texel columns
  int* out_i;
  float* out_f;
  int n, S, S_real, Q, Q_real, n_meshes, T, tex_out, p_tex, p_nm;
  float eps;
  // sphere_uv: the sphere-UV texel index (needs tex_out >= 1 and sph_tex).
  // exact_atlas: room for an exact-atlas variant, which the JAX package
  // does not run either (ROADMAP Queue A); the launcher refuses it.
  int sphere_uv, exact_atlas;
  // written by the launcher: persistent blocks, tables in shared memory
  int blocks, shared_tables;
};

namespace {

constexpr int ROUNDS = 1;  // tiles of 256 lanes (lanes.cuh)
constexpr int TILE = ROUNDS * tt::LANE_THREADS;
constexpr int SPH_COLS = 9;
constexpr int QUAD_COLS = 47;
constexpr int SPH_PAD = 12;   // a sphere row in shared memory: 3 float4s
constexpr int QUAD_PAD = 48;  // a quad row in shared memory: 12 float4s
constexpr float INF = 3.0e38f;
constexpr int SPH_TEX_COLS = 15;
// f32 constants of the sphere-UV index (tracer_torch/render/shading.py):
// 1/(2 pi) and 1/pi as f32 reciprocals, pi, and the clip of -n_y
constexpr float INV_2PI = 0x1.45f306p-3f;
constexpr float INV_PI = 0x1.45f306p-2f;
constexpr float PI_F = 0x1.921fb6p+1f;
constexpr float ACOS_LO = -0x1.fffffcp-1f;
constexpr float ACOS_HI = 0x1.fffffcp-1f;

// A table row: in shared memory (padded to whole float4s, read four
// columns to a load), or in the global table through the read-only cache.
template <bool kShared>
struct Row {
  const float* p;

  __device__ __forceinline__ float f(int c) const {
    if (kShared) return p[c];
    return __ldg(p + c);
  }
  // columns c .. c+3 (c a multiple of 4 and c + 3 within the row)
  __device__ __forceinline__ float4 q(int c) const {
    if (kShared) return *reinterpret_cast<const float4*>(p + c);
    return make_float4(__ldg(p + c), __ldg(p + c + 1), __ldg(p + c + 2),
                       __ldg(p + c + 3));
  }
};

template <bool kShared>
__device__ __forceinline__ Row<kShared> sph_row(const float* sph, int s) {
  return Row<kShared>{sph + s * (kShared ? SPH_PAD : SPH_COLS)};
}

template <bool kShared>
__device__ __forceinline__ Row<kShared> quad_row(const float* quad, int q) {
  return Row<kShared>{quad + q * (kShared ? QUAD_PAD : QUAD_COLS)};
}

// tracer/kernels/intersect.py::_staircase: image-relative nearest texel
__device__ __forceinline__ void staircase(float u, float v, float sx, float sy,
                                          float wf, float hf, int* x, int* y) {
  float xs = u * sx;
  float uu = xs - floorf(xs);
  float ys = v * sy;
  float vv = 1.0f - (ys - floorf(ys));
  int xi = (int)floorf(uu * (wf - 1.0f));
  int yi = (int)floorf(vv * (hf - 1.0f));
  int wi = (int)wf;
  int hi = (int)hf;
  *x = min(max(xi, 0), max(wi - 1, 0));
  *y = min(max(yi, 0), max(hi - 1, 0));
}

// The texel fields of a textured winner from its 15 texel columns c(k)
// (the quad table's 32 + k, or the sphere's sph_tex row): the pair-atlas
// index rel = (ya+yb)*wc + xa+xb as (row, sub) (integrator use_pair) and,
// with tex_out >= 2, the true atlas indices: the same staircase on the
// texture's and the normal map's own dims, clipped to the atlas.
template <typename Col>
__device__ __forceinline__ void texel_fields(const FirstHitsArgs& a, Col c,
                                             float u, float v, int* row,
                                             int* sub, int* idx_t,
                                             int* idx_n) {
  const float sx = c(0), sy = c(1);
  const float wa = c(2), wb = c(4);
  int xa, ya, xb, yb;
  staircase(u, v, sx, sy, wa, c(3), &xa, &ya);
  staircase(u, v, sx, sy, wb, c(5), &xb, &yb);
  const int wc = (int)wa + max((int)wb - 1, 0);
  const int rel = (ya + yb) * wc + xa + xb;
  *row = (int)c(6) + (rel >> 4);
  *sub = rel & 15;
  if (a.tex_out >= 2) {
    int xt, yt, xn, yn;
    const float tw = c(10), nw = c(13);
    staircase(u, v, sx, sy, tw, c(11), &xt, &yt);
    *idx_t = tt::clampi((int)c(9) + yt * (int)tw + xt, 0, a.p_tex - 1);
    staircase(u, v, sx, sy, nw, c(14), &xn, &yn);
    *idx_n = tt::clampi((int)c(12) + yn * (int)nw + xn, 0, a.p_nm - 1);
  }
}

// The integer fields of a lane that is not live.
__device__ __forceinline__ void dead_lane(const FirstHitsArgs& a, int i) {
  const int n = a.n;
  int* oi = a.out_i + i;
  oi[0] = -1;
  oi[n] = -1;
  oi[2 * n] = 0;
  oi[3 * n] = 0;
  oi[4 * n] = 0;
  if (a.tex_out >= 2) {
    oi[5 * n] = 0;
    oi[6 * n] = 0;
  }
}

// A live lane's ray.
struct Ray {
  float ox, oy, oz, dx, dy, dz, tm, a2;
};

__device__ __forceinline__ Ray load_ray(const FirstHitsArgs& a, int i) {
  Ray r;
  r.ox = a.ox[i]; r.oy = a.oy[i]; r.oz = a.oz[i];
  r.dx = a.dx[i]; r.dy = a.dy[i]; r.dz = a.dz[i];
  r.tm = a.tm[i];
  r.a2 = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  return r;
}

// The sphere and quad candidates of a live lane's ray: best, its closest t,
// and j, the winner (-1: none). With kReject, exact rejections skip a
// candidate's division and square root, where they are worth their
// divergence: for a warp whose rays share a direction octant (camera rays),
// which agree on the facing of the axis-aligned walls and mostly on the
// rest. The full test decides every candidate either way.
template <bool kShared, bool kReject>
__device__ __forceinline__ void candidates(const FirstHitsArgs& a,
                                           const float* sph,
                                           const float* quad, const Ray& y,
                                           float& best, int& j) {
  const float eps = a.eps;
  best = INF;
  j = -1;
  for (int s = 0; s < a.S_real; ++s) {
    const Row<kShared> r = sph_row<kShared>(sph, s);
    const float4 c0 = r.q(0), c4 = r.q(4);  // c, r; mb, valid
    if (kReject && !(c4.w > 0.5f)) continue;
    const float ocx = y.ox - (c0.x + y.tm * c4.x);
    const float ocy = y.oy - (c0.y + y.tm * c4.y);
    const float ocz = y.oz - (c0.z + y.tm * c4.z);
    const float b = 2.0f * (y.dx * ocx + y.dy * ocy + y.dz * ocz);
    if (kReject && !(b < 0.0f)) continue;  // -b - sqrt(delta) <= 0 (or NaN)
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c0.w * c0.w;
    const float delta = b * b - 4.0f * y.a2 * cc;
    if (kReject && !(delta >= 0.0f)) continue;
    const float num = -b - sqrtf(tt::maxf(delta, 0.0f));
    if (kReject && !(num > 0.0f)) continue;  // t <= 0 < eps
    const float t = num / (2.0f * y.a2);
    const bool ok = (delta >= 0.0f) && (t >= eps) && (c4.w > 0.5f);
    if (ok && t < best) {
      best = t;
      j = s;
    }
  }
  for (int q = 0; q < a.Q_real; ++q) {
    const Row<kShared> r = quad_row<kShared>(quad, q);
    // cols 8-11: eu.z, n; 20-23: mb.eu, er.er, eu.eu, glass; 24: valid
    const float4 c8 = r.q(8), c20 = r.q(20);
    const float valid = r.f(24);
    const float dotRN = y.dx * c8.y + y.dy * c8.z + y.dz * c8.w;
    const bool front = dotRN < 0.0f;
    const bool two_sided = c20.w > 0.5f;
    // back faces hit only glass (two-sided); dotRN == 0 never hits
    if (kReject &&
        (!(valid > 0.5f) || !(front || two_sided) || dotRN == 0.0f))
      continue;
    const float4 c12 = r.q(12), c16 = r.q(16);  // mb, v0.n; mb.n, v0.er, ..
    const float o_n = y.ox * c8.y + y.oy * c8.z + y.oz * c8.w;
    const float num = (c12.w + y.tm * c16.x) - o_n;
    // t = num / dotRN >= eps > 0 needs num and dotRN of one sign
    if (kReject && !(front ? num < 0.0f : num > 0.0f)) continue;
    const float t = num / (dotRN == 0.0f ? 1e-30f : dotRN);
    if (kReject && !(t >= eps && t < best)) continue;
    const float4 c0 = r.q(0), c4 = r.q(4);  // v0, er.x; er.yz, eu.xy
    const float o_er = y.ox * c0.w + y.oy * c4.x + y.oz * c4.y;
    const float d_er = y.dx * c0.w + y.dy * c4.x + y.dz * c4.y;
    const float s1 = o_er + t * d_er - (c16.y + y.tm * c16.z);
    const float o_eu = y.ox * c4.z + y.oy * c4.w + y.oz * c8.x;
    const float d_eu = y.dx * c4.z + y.dy * c4.w + y.dz * c8.x;
    const float s2 = o_eu + t * d_eu - (c16.w + y.tm * c20.x);
    bool ok = (dotRN != 0.0f) && (front || two_sided) && (t >= eps);
    ok = ok && (s1 >= 0.0f) && (s1 <= c20.y) && (s2 >= 0.0f) &&
         (s2 <= c20.z) && (valid > 0.5f);
    if (ok && t < best) {
      best = t;
      j = a.S + q;
    }
  }
}

// One live lane: the candidate loops (with the rejections where the
// warp's rays share a direction octant), the mesh candidates, the winner's
// detail and the lane's outputs.
template <bool kShared>
__device__ __forceinline__ void hit_lane(const FirstHitsArgs& a,
                                         const float* sph, const float* quad,
                                         int i) {
  const int n = a.n;
  const Ray ry = load_ray(a, i);
  const float ox = ry.ox, oy = ry.oy, oz = ry.oz;
  const float dx = ry.dx, dy = ry.dy, dz = ry.dz;
  const float tm = ry.tm, a2 = ry.a2;
  const float eps = a.eps;
  const unsigned warp = __activemask();
  const int oct = (dx < 0.0f) | (dy < 0.0f) << 1 | (dz < 0.0f) << 2;
  const bool coherent =
      __all_sync(warp, oct == __shfl_sync(warp, oct, __ffs(warp) - 1));
  float best;
  int j;
  if (coherent && eps > 0.0f)  // the rejections assume t <= 0 < eps
    candidates<kShared, true>(a, sph, quad, ry, best, j);
  else
    candidates<kShared, false>(a, sph, quad, ry, best, j);
  int tid = -1;
  for (int m = 0; m < a.n_meshes; ++m) {
    const float traw = a.t_mesh[(size_t)m * n + i];
    const float t = traw >= eps ? traw : INF;
    if (t < best) {
      best = t;
      j = a.S + a.Q + m;
      tid = a.tri_mesh[(size_t)m * n + i];
    }
  }

  // ---- the winner's detail only ----------------------------------------
  float px, py, pz, nx, ny, nz;
  float uq = 0.0f, vq = 0.0f, midf = 0.0f;
  int row = 0, sub = 0, idx_t = 0, idx_n = 0;
  if (j >= a.S && j < a.S + a.Q) {
    // quad detail (primitives.quad_hit_detail_planar): normal from er x eu
    const Row<kShared> qr = quad_row<kShared>(quad, j - a.S);
    const float tcx = qr.f(0) + tm * qr.f(12);
    const float tcy = qr.f(1) + tm * qr.f(13);
    const float tcz = qr.f(2) + tm * qr.f(14);
    const float ex = qr.f(3), ey = qr.f(4),
                ez = qr.f(5);
    const float ux = qr.f(6), uy = qr.f(7),
                uz = qr.f(8);
    midf = qr.f(25);
    const float cxq = ey * uz - ez * uy;
    const float cyq = ez * ux - ex * uz;
    const float czq = ex * uy - ey * ux;
    const float invq =
        1.0f / tt::maxf(sqrtf(cxq * cxq + cyq * cyq + czq * czq), 1e-20f);
    nx = cxq * invq;
    ny = cyq * invq;
    nz = czq * invq;
    const float dotRN = dx * nx + dy * ny + dz * nz;
    const float safe =
        fabsf(dotRN) < 1e-9f ? (dotRN < 0.0f ? -1e-9f : 1e-9f) : dotRN;
    const float tq = ((tcx * nx + tcy * ny + tcz * nz) -
                      (ox * nx + oy * ny + oz * nz)) / safe;
    px = ox + tq * dx;
    py = oy + tq * dy;
    pz = oz + tq * dz;
    const float qx = px - tcx, qy = py - tcy, qz = pz - tcz;
    uq = (qx * ex + qy * ey + qz * ez) /
         tt::maxf(ex * ex + ey * ey + ez * ez, 1e-30f);
    vq = (qx * ux + qy * uy + qz * uz) /
         tt::maxf(ux * ux + uy * uy + uz * uz, 1e-30f);
    if (a.tex_out)
      texel_fields(a, [&](int k) { return qr.f(32 + k); }, uq, vq, &row,
                   &sub, &idx_t, &idx_n);
  } else if (j >= a.S + a.Q) {  // a mesh winner: its triangle's hit detail
    midf = a.mesh_mid[j - a.S - a.Q];
    const tt::TriDetail td = tt::triangle_detail(
        a.pack + (size_t)tt::clampi(tid, 0, a.T - 1) * tt::MESH_PACK_COLS, ox,
        oy, oz, dx, dy, dz);
    px = td.px; py = td.py; pz = td.pz;
    nx = td.nx; ny = td.ny; nz = td.nz;
  } else {
    // sphere detail (primitives.sphere_hit_detail_planar); no winner reads
    // a zero row, as the TPU kernel's zeroed cache does
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f, c5 = 0.f,
          c6 = 0.f;
    if (j >= 0) {
      const Row<kShared> r = sph_row<kShared>(sph, j);
      c0 = r.f(0); c1 = r.f(1); c2 = r.f(2); c3 = r.f(3);
      c4 = r.f(4); c5 = r.f(5); c6 = r.f(6);
      midf = r.f(8);
    }
    const float tcx = c0 + tm * c4;
    const float tcy = c1 + tm * c5;
    const float tcz = c2 + tm * c6;
    const float ocx = ox - tcx, ocy = oy - tcy, ocz = oz - tcz;
    const float b = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - c3 * c3;
    const float delta = b * b - 4.0f * a2 * cc;
    const float sq = sqrtf(tt::maxf(delta, 1e-12f));
    const float ts = (-b - sq) / (2.0f * a2);
    px = ox + ts * dx;
    py = oy + ts * dy;
    pz = oz + ts * dz;
    const float nsx0 = px - tcx, nsy0 = py - tcy, nsz0 = pz - tcz;
    const float inv =
        1.0f / tt::maxf(sqrtf(nsx0 * nsx0 + nsy0 * nsy0 + nsz0 * nsz0),
                        1e-20f);
    nx = nsx0 * inv;
    ny = nsy0 * inv;
    nz = nsz0 * inv;
    if (a.sphere_uv && j >= 0) {  // Sphere.h:130; clamp keeps a NaN
      const float my = -ny;
      const float cy = my < ACOS_LO ? ACOS_LO : (my > ACOS_HI ? ACOS_HI : my);
      const float theta = acosf(cy);
      const float phi = atan2f(-nz, nx + 1e-20f) + PI_F;
      uq = phi * INV_2PI;
      vq = theta * INV_PI;
      const float* sr = a.sph_tex + (size_t)j * SPH_TEX_COLS;
      texel_fields(a, [&](int k) { return __ldg(sr + k); }, uq, vq, &row,
                   &sub, &idx_t, &idx_n);
    }
  }

  int* oi = a.out_i + i;
  float* of = a.out_f + i;
  oi[0] = best >= INF * 0.5f ? -1 : j;
  oi[n] = tid;
  oi[2 * n] = (int)midf;
  oi[3 * n] = row;
  oi[4 * n] = sub;
  if (a.tex_out >= 2) {
    oi[5 * n] = idx_t;
    oi[6 * n] = idx_n;
  }
  of[0] = px;
  of[n] = py;
  of[2 * n] = pz;
  of[3 * n] = nx;
  of[4 * n] = ny;
  of[5 * n] = nz;
  of[6 * n] = uq;
  of[7 * n] = vq;
}

template <bool kShared>
__global__ void __launch_bounds__(tt::LANE_THREADS)
first_hits_kernel(FirstHitsArgs a) {
  extern __shared__ float4 smem4[];  // the tables (kShared)
  __shared__ int list[TILE];
  __shared__ int counts[tt::TILE_COUNTS];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sph = a.sph;
  const float* quad = a.quad;
  if (kShared) {  // visible after list_tile's first barrier
    float* ssph = smem;
    float* squad = smem + a.S_real * SPH_PAD;
    for (int k = threadIdx.x; k < a.S_real * SPH_PAD; k += blockDim.x) {
      const int r = k / SPH_PAD, c = k - r * SPH_PAD;
      ssph[k] = c < SPH_COLS ? a.sph[r * SPH_COLS + c] : 0.0f;
    }
    for (int k = threadIdx.x; k < a.Q_real * QUAD_PAD; k += blockDim.x) {
      const int r = k / QUAD_PAD, c = k - r * QUAD_PAD;
      squad[k] = c < QUAD_COLS ? a.quad[r * QUAD_COLS + c] : 0.0f;
    }
    sph = ssph;
    quad = squad;
  }
  const int tiles = (a.n + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * TILE;
    const int cnt = tt::list_tile<ROUNDS>(
        t0, min(TILE, a.n - t0), list, counts,
        [&](int i) { return a.live[i] != 0; },
        [&](int i) { dead_lane(a, i); });
    for (int k = threadIdx.x; k < cnt; k += blockDim.x)
      hit_lane<kShared>(a, sph, quad, list[k]);
    __syncthreads();  // the next tile rewrites list and counts
  }
}

tt::SharedFit g_fit;

}  // namespace

extern "C" int tt_first_hits(FirstHitsArgs* args, void* stream) {
  FirstHitsArgs& a = *args;
  if (a.exact_atlas || (a.sphere_uv && (!a.tex_out || !a.sph_tex)))
    return (int)cudaErrorNotSupported;
  const size_t tables =
      sizeof(float) * (size_t)(a.S_real * SPH_PAD + a.Q_real * QUAD_PAD);
  const tt::SharedFit& fit =
      tt::fit_shared(g_fit, tables, tt::LANE_THREADS,
                     first_hits_kernel<true>, first_hits_kernel<false>);
  a.blocks = tt::lane_blocks(fit.blocks, a.n, TILE);
  a.shared_tables = fit.fits ? 1 : 0;
  if (fit.fits)
    first_hits_kernel<true><<<a.blocks, tt::LANE_THREADS, tables,
                              (cudaStream_t)stream>>>(a);
  else
    first_hits_kernel<false><<<a.blocks, tt::LANE_THREADS, 0,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
