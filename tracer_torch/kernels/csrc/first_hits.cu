// First-hit kernel for Hopper: closest hit over all spheres, quads and the
// meshes' BVH hits, then the winner's hit detail, one thread per ray.
//
// Replaces the TPU kernel tracer/kernels/intersect.py::first_hits (Pallas;
// body _kernel at intersect.py:122-379). The plain PyTorch version is
// tracer_torch/kernels/intersect.py::first_hits_plain; both follow the
// TPU kernel's expressions in the same order, and this file is built with
// --fmad=false, so the card reproduces the plain version bit for bit.
//
// Bound: memory and launch latency. Per ray it reads 32 B (+ 8 B per mesh)
// and writes 84 B (408,000 rays: about 47 MB per launch); the candidate
// loop is ~30 flops per primitive against tables that sit in shared
// memory. Everything per ray stays in registers; the winner's table row is
// read once after the loop.
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
//            forward's texel-cotangent fold; 0 unless a quad wins);
//          out_f [16, n] = p(3), n(3), u, v, tan(3), bitan(3), ptex, pnm.
// Mesh inputs: t_mesh [Nm, n] f32, tri_mesh [Nm, n] i32, mesh_mid [Nm] f32
// (the meshes' material ids), pack [T, 24] (intersect.py::mesh_tables).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mesh.cuh"

// Mirror of _Args in tracer_torch/kernels/intersect.py (same order).
struct FirstHitsArgs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tm;
  const unsigned char* live;
  const float *sph, *quad;
  const float* t_mesh;
  const int* tri_mesh;
  const float *mesh_mid, *pack;
  int* out_i;
  float* out_f;
  int n, S, S_real, Q, Q_real, n_meshes, T, tex_out, p_tex, p_nm;
  float eps;
};

namespace {

constexpr int SPH_COLS = 9;
constexpr int QUAD_COLS = 47;
constexpr float INF = 3.0e38f;
constexpr int THREADS = 256;

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

__global__ void __launch_bounds__(THREADS)
first_hits_kernel(FirstHitsArgs a) {
  extern __shared__ float smem[];
  float* ssph = smem;
  float* squad = smem + a.S_real * SPH_COLS;
  for (int k = threadIdx.x; k < a.S_real * SPH_COLS; k += blockDim.x)
    ssph[k] = a.sph[k];
  for (int k = threadIdx.x; k < a.Q_real * QUAD_COLS; k += blockDim.x)
    squad[k] = a.quad[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int n = a.n;
  int* oi = a.out_i + i;
  float* of = a.out_f + i;

  if (!a.live[i]) {
    oi[0] = -1;
    oi[n] = -1;
    oi[2 * n] = 0;
    oi[3 * n] = 0;
    oi[4 * n] = 0;
    if (a.tex_out >= 2) {
      oi[5 * n] = 0;
      oi[6 * n] = 0;
    }
    for (int k = 0; k < 16; ++k) of[k * n] = 0.0f;
    of[5 * n] = 1.0f;  // n = (0, 0, 1)
    return;
  }

  const float ox = a.ox[i], oy = a.oy[i], oz = a.oz[i];
  const float dx = a.dx[i], dy = a.dy[i], dz = a.dz[i];
  const float tm = a.tm[i];
  const float eps = a.eps;
  const float a2 = dx * dx + dy * dy + dz * dz;

  float best = INF;
  int j = -1;
  for (int s = 0; s < a.S_real; ++s) {
    const float* r = ssph + s * SPH_COLS;
    float ocx = ox - (r[0] + tm * r[4]);
    float ocy = oy - (r[1] + tm * r[5]);
    float ocz = oz - (r[2] + tm * r[6]);
    float b = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
    float cc = ocx * ocx + ocy * ocy + ocz * ocz - r[3] * r[3];
    float delta = b * b - 4.0f * a2 * cc;
    float t = (-b - sqrtf(tt::maxf(delta, 0.0f))) / (2.0f * a2);
    bool ok = (delta >= 0.0f) && (t >= eps) && (r[7] > 0.5f);
    if (ok && t < best) {
      best = t;
      j = s;
    }
  }
  for (int q = 0; q < a.Q_real; ++q) {
    const float* r = squad + q * QUAD_COLS;
    float dotRN = dx * r[9] + dy * r[10] + dz * r[11];
    float o_n = ox * r[9] + oy * r[10] + oz * r[11];
    float D = r[15] + tm * r[16];
    float t = (D - o_n) / (dotRN == 0.0f ? 1e-30f : dotRN);
    float o_er = ox * r[3] + oy * r[4] + oz * r[5];
    float d_er = dx * r[3] + dy * r[4] + dz * r[5];
    float s1 = o_er + t * d_er - (r[17] + tm * r[18]);
    float o_eu = ox * r[6] + oy * r[7] + oz * r[8];
    float d_eu = dx * r[6] + dy * r[7] + dz * r[8];
    float s2 = o_eu + t * d_eu - (r[19] + tm * r[20]);
    bool front = dotRN < 0.0f;
    bool two_sided = r[23] > 0.5f;
    bool ok = (dotRN != 0.0f) && (front || two_sided) && (t >= eps);
    ok = ok && (s1 >= 0.0f) && (s1 <= r[21]) && (s2 >= 0.0f) &&
         (s2 <= r[22]) && (r[24] > 0.5f);
    if (ok && t < best) {
      best = t;
      j = a.S + q;
    }
  }
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

  // ---- the winner's row, laid out as the TPU kernel's cache: a sphere
  // winner fills c, r, mb, midf and leaves every quad field at zero ------
  const bool is_s = j >= 0 && j < a.S;
  const bool is_q = j >= a.S && j < a.S + a.Q;
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f, c4 = 0.f, c5 = 0.f, c6 = 0.f;
  float ex = 0.f, ey = 0.f, ez = 0.f, ux = 0.f, uy = 0.f, uz = 0.f;
  float tnx = 0.f, tny = 0.f, tnz = 0.f, btx = 0.f, bty = 0.f, btz = 0.f;
  float midf = 0.f;
  const float* qr = nullptr;
  if (is_s) {
    const float* r = ssph + j * SPH_COLS;
    c0 = r[0]; c1 = r[1]; c2 = r[2]; c3 = r[3];
    c4 = r[4]; c5 = r[5]; c6 = r[6];
    midf = r[8];
  } else if (is_q) {
    qr = squad + (size_t)(j - a.S) * QUAD_COLS;
    c0 = qr[0]; c1 = qr[1]; c2 = qr[2];
    c4 = qr[12]; c5 = qr[13]; c6 = qr[14];
    ex = qr[3]; ey = qr[4]; ez = qr[5];
    ux = qr[6]; uy = qr[7]; uz = qr[8];
    tnx = qr[26]; tny = qr[27]; tnz = qr[28];
    btx = qr[29]; bty = qr[30]; btz = qr[31];
    midf = qr[25];
  }

  // sphere detail (primitives.sphere_hit_detail_planar)
  float tcx = c0 + tm * c4;
  float tcy = c1 + tm * c5;
  float tcz = c2 + tm * c6;
  float ocx = ox - tcx, ocy = oy - tcy, ocz = oz - tcz;
  float b = 2.0f * (dx * ocx + dy * ocy + dz * ocz);
  float cc = ocx * ocx + ocy * ocy + ocz * ocz - c3 * c3;
  float delta = b * b - 4.0f * a2 * cc;
  float sq = sqrtf(tt::maxf(delta, 1e-12f));
  float ts = (-b - sq) / (2.0f * a2);
  float psx = ox + ts * dx, psy = oy + ts * dy, psz = oz + ts * dz;
  float nsx0 = psx - tcx, nsy0 = psy - tcy, nsz0 = psz - tcz;
  float inv = 1.0f / tt::maxf(sqrtf(nsx0 * nsx0 + nsy0 * nsy0 + nsz0 * nsz0),
                              1e-20f);
  float nsx = nsx0 * inv, nsy = nsy0 * inv, nsz = nsz0 * inv;

  // quad detail (primitives.quad_hit_detail_planar): normal from er x eu
  float cxq = ey * uz - ez * uy;
  float cyq = ez * ux - ex * uz;
  float czq = ex * uy - ey * ux;
  float invq = 1.0f / tt::maxf(sqrtf(cxq * cxq + cyq * cyq + czq * czq),
                               1e-20f);
  float nqx = cxq * invq, nqy = cyq * invq, nqz = czq * invq;
  float dotRN = dx * nqx + dy * nqy + dz * nqz;
  float safe = fabsf(dotRN) < 1e-9f ? (dotRN < 0.0f ? -1e-9f : 1e-9f) : dotRN;
  float tq = ((tcx * nqx + tcy * nqy + tcz * nqz) -
              (ox * nqx + oy * nqy + oz * nqz)) / safe;
  float pqx = ox + tq * dx, pqy = oy + tq * dy, pqz = oz + tq * dz;
  float qx = pqx - tcx, qy = pqy - tcy, qz = pqz - tcz;
  float uq = (qx * ex + qy * ey + qz * ez) /
             tt::maxf(ex * ex + ey * ey + ez * ez, 1e-30f);
  float vq = (qx * ux + qy * uy + qz * uz) /
             tt::maxf(ux * ux + uy * uy + uz * uz, 1e-30f);

  int row = 0, sub = 0;
  float ptex = 0.0f, pnm = 0.0f;
  if (a.tex_out && is_q) {
    // pair-atlas index: rel = (ya+yb)*wc + xa+xb (integrator use_pair)
    int xa, ya, xb, yb;
    staircase(uq, vq, qr[32], qr[33], qr[34], qr[35], &xa, &ya);
    staircase(uq, vq, qr[32], qr[33], qr[36], qr[37], &xb, &yb);
    int wc = (int)qr[34] + max((int)qr[36] - 1, 0);
    int rel = (ya + yb) * wc + xa + xb;
    row = (int)qr[38] + (rel >> 4);
    sub = rel & 15;
    ptex = qr[39];
    pnm = qr[40];
  }
  if (a.tex_out >= 2) {
    // true atlas indices: the same staircase on the texture's and the
    // normal map's own dims, clipped to the atlas
    int idx_t = 0, idx_n = 0;
    if (is_q) {
      int xt, yt, xn, yn;
      staircase(uq, vq, qr[32], qr[33], qr[42], qr[43], &xt, &yt);
      idx_t = tt::clampi((int)qr[41] + yt * (int)qr[42] + xt, 0,
                         a.p_tex - 1);
      staircase(uq, vq, qr[32], qr[33], qr[45], qr[46], &xn, &yn);
      idx_n = tt::clampi((int)qr[44] + yn * (int)qr[45] + xn, 0,
                         a.p_nm - 1);
    }
    oi[5 * n] = idx_t;
    oi[6 * n] = idx_n;
  }

  float px = is_q ? pqx : psx, py = is_q ? pqy : psy, pz = is_q ? pqz : psz;
  float nx = is_q ? nqx : nsx, ny = is_q ? nqy : nsy, nz = is_q ? nqz : nsz;
  if (j >= a.S + a.Q) {  // a mesh winner: its triangle's hit detail
    midf = a.mesh_mid[j - a.S - a.Q];
    const tt::TriDetail td = tt::triangle_detail(
        a.pack + (size_t)tt::clampi(tid, 0, a.T - 1) * tt::MESH_PACK_COLS,
        ox, oy, oz, dx, dy, dz);
    px = td.px; py = td.py; pz = td.pz;
    nx = td.nx; ny = td.ny; nz = td.nz;
  }

  oi[0] = best >= INF * 0.5f ? -1 : j;
  oi[n] = tid;
  oi[2 * n] = (int)midf;
  oi[3 * n] = row;
  oi[4 * n] = sub;
  of[0] = px;
  of[n] = py;
  of[2 * n] = pz;
  of[3 * n] = nx;
  of[4 * n] = ny;
  of[5 * n] = nz;
  of[6 * n] = uq;
  of[7 * n] = vq;
  of[8 * n] = tnx;
  of[9 * n] = tny;
  of[10 * n] = tnz;
  of[11 * n] = btx;
  of[12 * n] = bty;
  of[13 * n] = btz;
  of[14 * n] = ptex;
  of[15 * n] = pnm;
}

}  // namespace

extern "C" int tt_first_hits(const FirstHitsArgs* args, void* stream) {
  const FirstHitsArgs a = *args;
  const int blocks = (a.n + THREADS - 1) / THREADS;
  const size_t smem =
      sizeof(float) * (size_t)(a.S_real * SPH_COLS + a.Q_real * QUAD_COLS);
  first_hits_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
