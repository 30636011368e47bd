// Shade+scatter kernel for Hopper: the rest of a bounce after the first
// hit, one thread per ray — sky on miss, material row and pair-atlas texel
// fetch, checker/image/emission select, normal mapping (squares only),
// direct light from given shadow factors, BSDF scatter on the PCG streams,
// and the wavefront state update.
//
// Replaces the TPU kernel tracer/kernels/shade.py::shade_scatter (Pallas;
// body _kernel at shade.py:90-379) and the XLA work that fed it: the
// material-row one-hot fetch (integrator._rows) and the pair-row gather
// with its one-hot sub-texel select (integrator.py:866-876) are reads by
// index here. The plain PyTorch version is
// tracer_torch/kernels/shade.py::shade_scatter_plain; both follow the TPU
// kernel's expressions in the same order, and this file is built with
// --fmad=false, so the card reproduces the plain version bit for bit.
//
// Bound: memory and launch latency. Per ray about 190 B in and out, a few
// dozen flops and ~10 hash rounds; everything stays in registers.
//
// Tables: mat [M, 20] (tracer_torch/kernels/shade.py::shade_mat_table),
// light [max(L,1), 6] (pos, color), pair [Rp, 32] int32 (16 texture words,
// then the 16 normal-map words of the same texels).
// Output: out [12, n] = o(3), d(3), throughput(3), acc(3) and active_out [n],
// or, for the last bounce, out [3, n] = acc. With rec_out (the record
// forward of the backward, pair atlas only) also rec [6, n] = the decoded
// texel img(3) and raw normal-map texel rnm(3) of every active lane, 0 on
// the others.
//
// Mesh winners (j >= S + Q, mesh scenes): p and n come from the first-hit
// record, which holds their triangle hit detail; the diffuse color is the
// corner colors of the pack row of tid (intersect.py::mesh_tables)
// interpolated at the hit (mesh.cuh) where has_col, else the material's
// untextured diffuse; their emission is zero (Scene.h:277,285).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bsdf.cuh"
#include "common.cuh"
#include "mesh.cuh"
#include "pcg.cuh"

// Mirror of _IO in tracer_torch/kernels/shade.py (same order).
struct ShadeIO {
  const float *dx, *dy, *dz, *ox, *oy, *oz, *thx, *thy, *thz, *ax, *ay, *az;
  const unsigned char* active;
  const int* key;  // uint32 key bits
  const int* j;
  const float *px, *py, *pz, *nx, *ny, *nz, *u, *v;
  const float *tnx, *tny, *tnz, *btx, *bty, *btz;
  const int *mid, *row, *sub;
  const float *ptex, *pnm;
  const float* shadows;  // [L, n]
  const float* mat;
  const float* light;
  const int* pair;
  float* out;
  unsigned char* active_out;
  float* rec;
  const int* tid;     // mesh scenes: the winning triangle
  const float* pack;  // mesh scenes: [T, 24] mesh pack
};

// Mirror of _Params in tracer_torch/kernels/shade.py (same order).
struct ShadeParams {
  int n, M, Rp, L, S, Q, ref, has_pair, last, rec_out, n_meshes, T;
  float eps, n_rem, dark;
};

namespace {

constexpr int MAT_COLS = 20;
constexpr int PACK_BLOCK = 16;
constexpr int THREADS = 256;
constexpr int GLASS = 1;
constexpr int MIRROR = 2;
constexpr int TEX_NONE = 0;
constexpr int TEX_CHECKERBOARD = 1;
constexpr int TEX_IMAGE = 2;

// packed 0xRRGGBB word -> rgb, byte * f32(1/255)
__device__ __forceinline__ void decode(int w, float* r, float* g, float* b) {
  const float k = 1.0f / 255.0f;
  *r = (float)((w >> 16) & 0xFF) * k;
  *g = (float)((w >> 8) & 0xFF) * k;
  *b = (float)(w & 0xFF) * k;
}

__global__ void __launch_bounds__(THREADS)
shade_scatter_kernel(ShadeIO io, ShadeParams p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int n = p.n;
  float* out = io.out + i;
  const float accx = io.ax[i], accy = io.ay[i], accz = io.az[i];
  const bool last = p.last != 0;

  if (!io.active[i]) {  // pass-through
    if (p.rec_out)
      for (int k = 0; k < 6; ++k) io.rec[i + k * n] = 0.0f;
    if (last) {
      out[0] = accx;
      out[n] = accy;
      out[2 * n] = accz;
    } else {
      out[0] = io.ox[i];
      out[n] = io.oy[i];
      out[2 * n] = io.oz[i];
      out[3 * n] = io.dx[i];
      out[4 * n] = io.dy[i];
      out[5 * n] = io.dz[i];
      out[6 * n] = io.thx[i];
      out[7 * n] = io.thy[i];
      out[8 * n] = io.thz[i];
      out[9 * n] = accx;
      out[10 * n] = accy;
      out[11 * n] = accz;
      io.active_out[i] = 0;
    }
    return;
  }

  const bool ref = p.ref != 0;
  const float eps = p.eps;
  const float dx = io.dx[i], dy = io.dy[i], dz = io.dz[i];
  const float thx = io.thx[i], thy = io.thy[i], thz = io.thz[i];
  const int j_enc = io.j[i];
  const bool miss = j_enc < 0;
  const int j = j_enc < 0 ? 0 : j_enc;
  const bool live = !miss;
  const bool is_quad = j >= p.S && j < p.S + p.Q;
  const float u = io.u[i], v = io.v[i];

  // ---- sky on miss (procedural skybox) ---------------------------------
  float skx, sky, skz;
  {
    float a = 0.5f * (dy + 1.0f);
    float scale = ref ? p.n_rem + 1.0f : 1.0f;
    float w = 1.0f - a;
    float k = 1.0f - p.dark;
    skx = k * (w + a * 0.5f * scale);
    sky = k * (w + a * 0.7f * scale);
    skz = k * (w + a * 1.0f * scale);
  }
  float ax = accx + (miss ? thx * skx : 0.0f);
  float ay = accy + (miss ? thy * sky : 0.0f);
  float az = accz + (miss ? thz * skz : 0.0f);

  // ---- material row by mid ---------------------------------------------
  const float* mr = io.mat + tt::clampi(io.mid[i], 0, p.M - 1) * MAT_COLS;
  const float dfx = mr[0], dfy = mr[1], dfz = mr[2];
  const float c1x = mr[3], c1y = mr[4], c1z = mr[5];
  const float c2x = mr[6], c2y = mr[7], c2z = mr[8];
  const float lcx = mr[9], lcy = mr[10], lcz = mr[11];
  const float k_emit = mr[12], transp = mr[13], ior = mr[14];
  const int mtype = (int)mr[15];
  const int textype = (int)mr[16];
  const float use_nmf = mr[17], sx = mr[18], sy = mr[19];
  const float px = io.px[i], py = io.py[i], pz = io.pz[i];
  float nx = io.nx[i], ny = io.ny[i], nz = io.nz[i];

  // ---- texturing --------------------------------------------------------
  const bool same = tt::trunc_mod2(u * sx) == tt::trunc_mod2(v * sy);
  const float chx = same ? c1x : c2x;
  const float chy = same ? c1y : c2y;
  const float chz = same ? c1z : c2z;
  const bool same8 = tt::trunc_mod2(u * 8.0f) == tt::trunc_mod2(v * 8.0f);
  const float on = same8 ? 0.0f : 1.0f;  // magenta (Material.cpp:74-81)
  float fbx = on, fby = 0.0f, fbz = on;
  int vn = 0;
  if (p.has_pair) {
    const int* prow =
        io.pair + (size_t)tt::clampi(io.row[i], 0, p.Rp - 1) * 2 * PACK_BLOCK;
    const int sub = io.sub[i];
    float imx, imy, imz;
    decode(prow[sub], &imx, &imy, &imz);
    if (p.rec_out) {
      io.rec[i] = imx;
      io.rec[i + n] = imy;
      io.rec[i + 2 * n] = imz;
    }
    vn = prow[PACK_BLOCK + sub];
    if (io.ptex[i] > 0.5f) {
      fbx = imx;
      fby = imy;
      fbz = imz;
    }
  }
  const bool is_check = textype == TEX_CHECKERBOARD;
  const bool is_img = textype == TEX_IMAGE;
  float dcx = is_img ? fbx : (is_check ? chx : dfx);
  float dcy = is_img ? fby : (is_check ? chy : dfy);
  float dcz = is_img ? fbz : (is_check ? chz : dfz);
  const bool is_mesh = p.n_meshes > 0 && j >= p.S + p.Q;
  if (is_mesh) {  // corner colors at the hit (Scene.h:291-298)
    const float* r =
        io.pack + (size_t)tt::clampi(io.tid[i], 0, p.T - 1) *
                      tt::MESH_PACK_COLS;
    if (r[18] > 0.5f) {
      const tt::TriDetail td =
          tt::triangle_detail(r, io.ox[i], io.oy[i], io.oz[i], dx, dy, dz);
      dcx = td.w0 * r[9] + td.w1 * r[12] + td.w2 * r[15];
      dcy = td.w0 * r[10] + td.w1 * r[13] + td.w2 * r[16];
      dcz = td.w0 * r[11] + td.w1 * r[14] + td.w2 * r[17];
    } else {
      dcx = dfx;
      dcy = dfy;
      dcz = dfz;
    }
  }

  // ---- normal mapping (squares only, Scene.h:284) -----------------------
  if (p.has_pair) {
    float rnx, rny, rnz;
    decode(vn, &rnx, &rny, &rnz);
    if (p.rec_out) {
      io.rec[i + 3 * n] = rnx;
      io.rec[i + 4 * n] = rny;
      io.rec[i + 5 * n] = rnz;
    }
    float nmx = 2.0f * rnx - 1.0f;
    float nmy = 2.0f * rny - 1.0f;
    float nmz = 2.0f * rnz - 1.0f;
    float n2x = nmx * io.tnx[i] + nmy * io.btx[i] + nmz * nx;
    float n2y = nmx * io.tny[i] + nmy * io.bty[i] + nmz * ny;
    float n2z = nmx * io.tnz[i] + nmy * io.btz[i] + nmz * nz;
    tt::normalize3(&n2x, &n2y, &n2z);
    if (is_quad && io.pnm[i] > 0.5f && use_nmf > 0.5f) {
      nx = n2x;
      ny = n2y;
      nz = n2z;
    }
  }

  // ---- emission (spheres and squares only) ------------------------------
  const bool is_none = textype == TEX_NONE;
  const float ecx = is_none ? lcx : (is_img ? fbx : (is_check ? chx : lcx));
  const float ecy = is_none ? lcy : (is_img ? fby : (is_check ? chy : lcy));
  const float ecz = is_none ? lcz : (is_img ? fbz : (is_check ? chz : lcz));
  const float kem = is_mesh ? 0.0f : k_emit;  // Scene.h:277,285
  const float emx = kem * ecx, emy = kem * ecy, emz = kem * ecz;

  // ---- direct lighting from the given shadow factors -------------------
  float clx = 0.0f, cly = 0.0f, clz = 0.0f;
  for (int l = 0; l < p.L; ++l) {
    const float* lt = io.light + l * 6;
    float ldx = lt[0] - px, ldy = lt[1] - py, ldz = lt[2] - pz;
    tt::normalize3(&ldx, &ldy, &ldz);
    float dotLN = ldx * nx + ldy * ny + ldz * nz;
    const float* lc = io.light + (ref ? 0 : l) * 6;  // lights[0] quirk
    float lam = tt::maxf(dotLN, 0.0f) * (1.0f - transp);
    float cxi = lc[3] * dcx * lam;
    float cyi = lc[4] * dcy * lam;
    float czi = lc[5] * dcz * lam;
    float sh = io.shadows[(size_t)l * n + i];
    if (ref) {
      clx = sh * (clx + cxi);
      cly = sh * (cly + cyi);
      clz = sh * (clz + czi);
    } else {
      clx = clx + cxi * sh;
      cly = cly + cyi * sh;
      clz = clz + czi * sh;
    }
  }
  const float oax = ax + (live ? thx * (clx + emx) : 0.0f);
  const float oay = ay + (live ? thy * (cly + emy) : 0.0f);
  const float oaz = az + (live ? thz * (clz + emz) : 0.0f);
  if (last) {
    out[0] = oax;
    out[n] = oay;
    out[2 * n] = oaz;
    return;
  }
  out[9 * n] = oax;
  out[10 * n] = oay;
  out[11 * n] = oaz;
  if (!live) {
    out[0] = io.ox[i];
    out[n] = io.oy[i];
    out[2 * n] = io.oz[i];
    out[3 * n] = dx;
    out[4 * n] = dy;
    out[5 * n] = dz;
    out[6 * n] = thx;
    out[7 * n] = thy;
    out[8 * n] = thz;
    io.active_out[i] = 0;
    return;
  }

  // ---- BSDF scatter (Material.cpp:26-60) --------------------------------
  const uint32_t bk = (uint32_t)io.key[i];
  const float ddn = dx * nx + dy * ny + dz * nz;
  const tt::GlassLobe lobe = tt::glass_lobe(ddn, ior, ref, bk);
  const float ri = lobe.ri;
  const bool use_reflect = lobe.reflect;
  const float kr = 2.0f * ddn;
  const float rfx = dx - kr * nx, rfy = dy - kr * ny, rfz = dz - kr * nz;
  const float cth = tt::minf(ddn, 1.0f);
  const float ppx = ri * (cth * nx + dx);
  const float ppy = ri * (cth * ny + dy);
  const float ppz = ri * (cth * nz + dz);
  const float kk = fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz));
  const float par = -sqrtf(tt::maxf(kk, 1e-12f));
  const float gx = use_reflect ? rfx : par * nx + ppx;
  const float gy = use_reflect ? rfy : par * ny + ppy;
  const float gz = use_reflect ? rfz : par * nz + ppz;

  float rux, ruy, ruz;
  tt::scatter_sample(bk, ref, &rux, &ruy, &ruz);
  float ddfx = nx + rux, ddfy = ny + ruy, ddfz = nz + ruz;
  if (sqrtf(ddfx * ddfx + ddfy * ddfy + ddfz * ddfz) <= eps) {
    ddfx = nx;
    ddfy = ny;
    ddfz = nz;
  }
  float dox, doy, doz;
  if (mtype == GLASS) {
    dox = gx; doy = gy; doz = gz;
  } else if (mtype == MIRROR) {
    dox = rfx; doy = rfy; doz = rfz;
  } else {
    dox = ddfx; doy = ddfy; doz = ddfz;
  }
  tt::normalize3(&dox, &doy, &doz);
  out[0] = eps * dox + px;
  out[n] = eps * doy + py;
  out[2 * n] = eps * doz + pz;
  out[3 * n] = dox;
  out[4 * n] = doy;
  out[5 * n] = doz;
  out[6 * n] = thx * dcx;
  out[7 * n] = thy * dcy;
  out[8 * n] = thz * dcz;
  io.active_out[i] = 1;
}

}  // namespace

extern "C" int tt_shade_scatter(const ShadeIO* io, const ShadeParams* prm,
                                void* stream) {
  const int blocks = (prm->n + THREADS - 1) / THREADS;
  shade_scatter_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*io,
                                                                     *prm);
  return (int)cudaGetLastError();
}
