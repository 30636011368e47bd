// Shade+scatter kernel for Hopper: the rest of a bounce after the first
// hit, for the active lanes of a ray batch — sky on miss, material row and
// pair-atlas texel fetch, checker/image/emission select, normal mapping
// (squares only), direct light from given shadow factors, BSDF scatter on
// the PCG streams, and the wavefront state update, in place.
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
// Bound: memory traffic and, on sparse bounces, the lanes that are not
// active. A live lane reads ~100 B (its state, hit record, key, shadow
// factors and two texel words) and writes 48 B. The first port read and
// wrote the 12 state floats of every lane into a fresh output each bounce
// (96 B per dead lane), read the tangent frame and the atlas masks as 8
// per-lane planes and the material rows by scalar global loads, and
// mixed dead lanes into nearly every warp. The design:
// - the bounce state is updated in place: the integrator's trace owns one
//   set of state buffers per call, and a lane that is not active costs its
//   active flag (and, with rec_out, its zero record);
// - persistent blocks (lanes.cuh) walk tiles of 512 lanes, each tile's
//   active lanes listed in shared memory, so the BSDF, hash and light work
//   runs on full warps of active lanes; at most 64 registers, so that
//   four blocks share an SM (on an H100, on the dense flat box, the lanes
//   in flight, not the bytes, set the time);
// - the material rows, the light rows and the quads' per-quad constants
//   (tangent frame, ptex, pnm: columns 26-31, 39, 40 of the first-hit quad
//   table, read by j as B3 reads them) sit in dynamic shared memory, or
//   are read through L2 (__ldg) beyond a block's 227 KB;
// - the two dependent pair-word gathers are issued first.
//
// Tables: mat [M, 20] (tracer_torch/kernels/shade.py::shade_mat_table),
// light [max(L,1), 6] (pos, color), quad [Q, 47] (intersect.py::
// intersect_tables), pair [Rp, 32] int32 (16 texture words, then the 16
// normal-map words of the same texels).
// State (read and written in place, planar [n]): o(3), d(3),
// throughput(3), acc(3), active. An active lane adds its radiance to acc;
// before the last bounce a lane that hits writes its next o, d and
// throughput, and a lane that misses clears its active flag. Lanes that
// are not active are not touched. With rec_out (the record forward of the
// backward, pair atlas only) also rec [8, n] = the decoded texel img(3),
// the raw normal-map texel rnm(3), ptex and pnm of every active lane, 0
// on the others.
//
// Image skies (has_sky): a miss lane's sky is the equirect texel of its
// direction, u = 0.5 + atan2(d_z, d_x) / (2 pi), v = 0.5 - asin(clip(d_y,
// -1, 1)) / pi, x = int(u * W), y = int(v * H) (each clipped), the packed
// word sky[y * W + x] (scene.sky_pack) decoded and, under compat=
// reference, scaled by NRemainingBounces (not + 1: Scene.h:155-160). The
// JAX package computes it for every lane in XLA and hands it in
// (tracer/kernels/shade.py:115-116, 167-177); here only miss lanes do,
// with no glue launch.
//
// Textured spheres (sphere_uv): a sphere winner's ptex and pnm are its
// material's pair-atlas masks, mat_pair [M, 2] (shade.py::mat_pair_table),
// as the JAX package's sphere-UV splice gives them; its row and sub come
// from the first-hit kernel's sphere-UV index.
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
#include "lanes.cuh"
#include "mesh.cuh"
#include "pcg.cuh"

// Mirror of _IO in tracer_torch/kernels/shade.py (same order).
struct ShadeIO {
  float *ox, *oy, *oz, *dx, *dy, *dz, *thx, *thy, *thz, *ax, *ay, *az;
  unsigned char* active;
  const long long* key;  // uint32 keys in int64 (the low word is read)
  const int* j;
  const float *px, *py, *pz, *nx, *ny, *nz, *u, *v;
  const int *mid, *row, *sub;
  const float* shadows;  // [L, n]
  const float* mat;
  const float* light;
  const float* quad;
  const int* pair;
  float* rec;
  const int* tid;     // mesh scenes: the winning triangle
  const float* pack;  // mesh scenes: [T, 24] mesh pack
  const int* sky;         // image skies: packed words [sky_n rounded up]
  const float* mat_pair;  // textured spheres: [M, 2] ptex, pnm
  // room for an exact-atlas variant (refused: ROADMAP Queue A)
  const float *tex_data, *nm_data;
};

// Mirror of _Params in tracer_torch/kernels/shade.py (same order).
struct ShadeParams {
  int n, M, Rp, L, S, Q, ref, has_pair, last, rec_out, n_meshes, T;
  // has_sky: the image sky (sky, sky_w x sky_h, sky_n texels); sphere_uv:
  // the sphere winners' masks from mat_pair; exact_atlas is refused
  int has_sky, exact_atlas, sphere_uv, sky_w, sky_h, sky_n;
  float eps, n_rem, dark;
  // >= 0: key holds the sample's keys, and this bounce's are
  // mix(key, salt) (the bounce index); -1: key holds this bounce's keys
  int salt;
  // written by the launcher: persistent blocks, tables in shared memory
  int blocks, shared_tables;
};

namespace {

constexpr int ROUNDS = 2;  // tiles of 2 x 256 lanes (lanes.cuh)
constexpr int TILE = ROUNDS * tt::LANE_THREADS;
constexpr int MAT_COLS = 20;
constexpr int QUAD_COLS = 47;
constexpr int FRAME_COLS = 8;  // tan(3), bitan(3), ptex, pnm
constexpr int PACK_BLOCK = 16;
constexpr int GLASS = 1;
constexpr int MIRROR = 2;
constexpr int TEX_NONE = 0;
constexpr int TEX_CHECKERBOARD = 1;
constexpr int TEX_IMAGE = 2;
// 1/(2 pi) and 1/pi as f32 reciprocals (tracer_torch/render/shading.py)
constexpr float INV_2PI = 0x1.45f306p-3f;
constexpr float INV_PI = 0x1.45f306p-2f;

// packed 0xRRGGBB word -> rgb, byte * f32(1/255)
__device__ __forceinline__ void decode(int w, float* r, float* g, float* b) {
  const float k = 1.0f / 255.0f;
  *r = (float)((w >> 16) & 0xFF) * k;
  *g = (float)((w >> 8) & 0xFF) * k;
  *b = (float)(w & 0xFF) * k;
}

// A miss lane's image sky (shading.py::sky_texel_index + the packed word);
// the clamp of d_y keeps a NaN, as torch.clamp does.
__device__ __forceinline__ void sky_image(const ShadeIO& io,
                                          const ShadeParams& p, float dx,
                                          float dy, float dz, float* r,
                                          float* g, float* b) {
  const float u = 0.5f + atan2f(dz, dx) * INV_2PI;
  const float cy = dy < -1.0f ? -1.0f : (dy > 1.0f ? 1.0f : dy);
  const float v = 0.5f - asinf(cy) * INV_PI;
  const int x = tt::clampi((int)(u * (float)p.sky_w), 0, p.sky_w - 1);
  const int y = tt::clampi((int)(v * (float)p.sky_h), 0, p.sky_h - 1);
  const int idx = tt::clampi(y * p.sky_w + x, 0, p.sky_n - 1);
  decode(__ldg(io.sky + idx), r, g, b);
  if (p.ref) {
    *r = p.n_rem * *r;
    *g = p.n_rem * *g;
    *b = p.n_rem * *b;
  }
}

// The tables a lane reads: in shared memory, or the global ones (the
// frame then reads the quad table's columns 26-31, 39, 40 in place).
template <bool kShared>
struct Tables {
  const float *mat, *light, *frame;

  __device__ __forceinline__ float ld(const float* p) const {
    if (kShared) return *p;
    return __ldg(p);
  }
  __device__ __forceinline__ float m(int row, int c) const {
    return ld(mat + row * MAT_COLS + c);
  }
  __device__ __forceinline__ float l(int row, int c) const {
    return ld(light + row * 6 + c);
  }
  __device__ __forceinline__ float f(int q, int c) const {
    if (kShared) return frame[q * FRAME_COLS + c];
    return __ldg(frame + q * QUAD_COLS + (c < 6 ? c : c + 7));
  }
};

template <bool kShared>
__device__ __forceinline__ void shade_lane(const ShadeIO& io,
                                           const ShadeParams& p,
                                           const Tables<kShared>& tb, int i) {
  const int n = p.n;
  const bool last = p.last != 0;
  const bool ref = p.ref != 0;
  const int j_enc = io.j[i];
  const bool miss = j_enc < 0;
  const int j = j_enc < 0 ? 0 : j_enc;
  const bool live = !miss;
  const bool is_quad = j >= p.S && j < p.S + p.Q;

  // the pair-atlas words first: two dependent gathers
  int vt = 0, vn = 0;
  if (p.has_pair) {
    const int* prow =
        io.pair + (size_t)tt::clampi(io.row[i], 0, p.Rp - 1) * 2 * PACK_BLOCK;
    const int sub = io.sub[i];
    vt = __ldg(prow + sub);
    vn = __ldg(prow + PACK_BLOCK + sub);
  }
  const float dx = io.dx[i], dy = io.dy[i], dz = io.dz[i];
  const float thx = io.thx[i], thy = io.thy[i], thz = io.thz[i];
  const float u = io.u[i], v = io.v[i];

  // ---- sky on miss -------------------------------------------------------
  float skx, sky, skz;
  if (p.has_sky) {
    skx = sky = skz = 0.0f;
    if (miss) sky_image(io, p, dx, dy, dz, &skx, &sky, &skz);
  } else {
    float a = 0.5f * (dy + 1.0f);
    float scale = ref ? p.n_rem + 1.0f : 1.0f;
    float w = 1.0f - a;
    float k = 1.0f - p.dark;
    skx = k * (w + a * 0.5f * scale);
    sky = k * (w + a * 0.7f * scale);
    skz = k * (w + a * 1.0f * scale);
  }
  const float ax = io.ax[i] + (miss ? thx * skx : 0.0f);
  const float ay = io.ay[i] + (miss ? thy * sky : 0.0f);
  const float az = io.az[i] + (miss ? thz * skz : 0.0f);

  // ---- material row by mid ---------------------------------------------
  const int mr = tt::clampi(io.mid[i], 0, p.M - 1);
  const float dfx = tb.m(mr, 0), dfy = tb.m(mr, 1), dfz = tb.m(mr, 2);
  const float transp = tb.m(mr, 13), ior = tb.m(mr, 14);
  const int mtype = (int)tb.m(mr, 15);
  const int textype = (int)tb.m(mr, 16);
  const float use_nmf = tb.m(mr, 17), sx = tb.m(mr, 18), sy = tb.m(mr, 19);
  const float px = io.px[i], py = io.py[i], pz = io.pz[i];
  float nx = io.nx[i], ny = io.ny[i], nz = io.nz[i];
  // the winning quad's atlas masks (0 unless a quad wins, or with
  // sphere_uv a sphere: its material's)
  const int fq = live && is_quad ? j - p.S : -1;
  float ptex = fq >= 0 ? tb.f(fq, 6) : 0.0f;
  float pnm = fq >= 0 ? tb.f(fq, 7) : 0.0f;
  if (p.sphere_uv && live && j < p.S) {
    ptex = __ldg(io.mat_pair + 2 * mr);
    pnm = __ldg(io.mat_pair + 2 * mr + 1);
  }

  // ---- texturing --------------------------------------------------------
  const bool same = tt::trunc_mod2(u * sx) == tt::trunc_mod2(v * sy);
  const float chx = same ? tb.m(mr, 3) : tb.m(mr, 6);
  const float chy = same ? tb.m(mr, 4) : tb.m(mr, 7);
  const float chz = same ? tb.m(mr, 5) : tb.m(mr, 8);
  const bool same8 = tt::trunc_mod2(u * 8.0f) == tt::trunc_mod2(v * 8.0f);
  const float on = same8 ? 0.0f : 1.0f;  // magenta (Material.cpp:74-81)
  float fbx = on, fby = 0.0f, fbz = on;
  if (p.has_pair) {
    float imx, imy, imz;
    decode(vt, &imx, &imy, &imz);
    if (p.rec_out) {
      io.rec[i] = imx;
      io.rec[i + n] = imy;
      io.rec[i + 2 * n] = imz;
      io.rec[i + 6 * n] = ptex;
      io.rec[i + 7 * n] = pnm;
    }
    if (ptex > 0.5f) {
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
    if (is_quad && pnm > 0.5f && use_nmf > 0.5f) {
      const float nmx = 2.0f * rnx - 1.0f;
      const float nmy = 2.0f * rny - 1.0f;
      const float nmz = 2.0f * rnz - 1.0f;
      float n2x = nmx * tb.f(fq, 0) + nmy * tb.f(fq, 3) + nmz * nx;
      float n2y = nmx * tb.f(fq, 1) + nmy * tb.f(fq, 4) + nmz * ny;
      float n2z = nmx * tb.f(fq, 2) + nmy * tb.f(fq, 5) + nmz * nz;
      tt::normalize3(&n2x, &n2y, &n2z);
      nx = n2x;
      ny = n2y;
      nz = n2z;
    }
  }

  // ---- emission (spheres and squares only) ------------------------------
  const float lcx = tb.m(mr, 9), lcy = tb.m(mr, 10), lcz = tb.m(mr, 11);
  const bool is_none = textype == TEX_NONE;
  const float ecx = is_none ? lcx : (is_img ? fbx : (is_check ? chx : lcx));
  const float ecy = is_none ? lcy : (is_img ? fby : (is_check ? chy : lcy));
  const float ecz = is_none ? lcz : (is_img ? fbz : (is_check ? chz : lcz));
  const float kem = is_mesh ? 0.0f : tb.m(mr, 12);  // Scene.h:277,285
  const float emx = kem * ecx, emy = kem * ecy, emz = kem * ecz;

  // ---- direct lighting from the given shadow factors -------------------
  float clx = 0.0f, cly = 0.0f, clz = 0.0f;
  for (int l = 0; l < p.L; ++l) {
    float ldx = tb.l(l, 0) - px, ldy = tb.l(l, 1) - py, ldz = tb.l(l, 2) - pz;
    tt::normalize3(&ldx, &ldy, &ldz);
    const float dotLN = ldx * nx + ldy * ny + ldz * nz;
    const int lc = ref ? 0 : l;  // lights[0] quirk
    const float lam = tt::maxf(dotLN, 0.0f) * (1.0f - transp);
    const float cxi = tb.l(lc, 3) * dcx * lam;
    const float cyi = tb.l(lc, 4) * dcy * lam;
    const float czi = tb.l(lc, 5) * dcz * lam;
    const float sh = io.shadows[(size_t)l * n + i];
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
  io.ax[i] = ax + (live ? thx * (clx + emx) : 0.0f);
  io.ay[i] = ay + (live ? thy * (cly + emy) : 0.0f);
  io.az[i] = az + (live ? thz * (clz + emz) : 0.0f);
  if (last) return;
  if (!live) {
    io.active[i] = 0;
    return;
  }

  // ---- BSDF scatter (Material.cpp:26-60) --------------------------------
  const uint32_t bk = p.salt >= 0
                          ? tt::mix((uint32_t)io.key[i], (uint32_t)p.salt)
                          : (uint32_t)io.key[i];
  const float ddn = dx * nx + dy * ny + dz * nz;
  float dox, doy, doz;
  if (mtype == GLASS) {
    const tt::GlassLobe lobe = tt::glass_lobe(ddn, ior, ref, bk);
    const float kr = 2.0f * ddn;
    if (lobe.reflect) {
      dox = dx - kr * nx;
      doy = dy - kr * ny;
      doz = dz - kr * nz;
    } else {
      const float ri = lobe.ri;
      const float cth = tt::minf(ddn, 1.0f);
      const float ppx = ri * (cth * nx + dx);
      const float ppy = ri * (cth * ny + dy);
      const float ppz = ri * (cth * nz + dz);
      const float kk = fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz));
      const float par = -sqrtf(tt::maxf(kk, 1e-12f));
      dox = par * nx + ppx;
      doy = par * ny + ppy;
      doz = par * nz + ppz;
    }
  } else if (mtype == MIRROR) {
    const float kr = 2.0f * ddn;
    dox = dx - kr * nx;
    doy = dy - kr * ny;
    doz = dz - kr * nz;
  } else {
    float rux, ruy, ruz;
    tt::scatter_sample(bk, ref, &rux, &ruy, &ruz);
    dox = nx + rux;
    doy = ny + ruy;
    doz = nz + ruz;
    if (sqrtf(dox * dox + doy * doy + doz * doz) <= p.eps) {
      dox = nx;
      doy = ny;
      doz = nz;
    }
  }
  tt::normalize3(&dox, &doy, &doz);
  io.ox[i] = p.eps * dox + px;
  io.oy[i] = p.eps * doy + py;
  io.oz[i] = p.eps * doz + pz;
  io.dx[i] = dox;
  io.dy[i] = doy;
  io.dz[i] = doz;
  io.thx[i] = thx * dcx;
  io.thy[i] = thy * dcy;
  io.thz[i] = thz * dcz;
}

// The zero record of a lane that is not active.
__device__ __forceinline__ void dead_lane(const ShadeIO& io,
                                          const ShadeParams& p, int i) {
  if (p.rec_out)
    for (int k = 0; k < 8; ++k) io.rec[i + (size_t)k * p.n] = 0.0f;
}

// four blocks of 256 threads an SM: at most 64 registers a thread
template <bool kShared>
__global__ void __launch_bounds__(tt::LANE_THREADS, 4)
shade_scatter_kernel(ShadeIO io, ShadeParams p) {
  extern __shared__ float4 smem4[];  // the tables (kShared)
  __shared__ int list[TILE];
  __shared__ int counts[tt::TILE_COUNTS];
  Tables<kShared> tb{io.mat, io.light, io.quad + 26};
  if (kShared) {  // visible after list_tile's first barrier
    float* smat = reinterpret_cast<float*>(smem4);
    float* slight = smat + p.M * MAT_COLS;
    float* sframe = slight + p.L * 6;
    for (int k = threadIdx.x; k < p.M * MAT_COLS; k += blockDim.x)
      smat[k] = io.mat[k];
    for (int k = threadIdx.x; k < p.L * 6; k += blockDim.x)
      slight[k] = io.light[k];
    for (int k = threadIdx.x; k < p.Q * FRAME_COLS; k += blockDim.x) {
      const int q = k / FRAME_COLS, c = k - q * FRAME_COLS;
      sframe[k] = io.quad[q * QUAD_COLS + 26 + (c < 6 ? c : c + 7)];
    }
    tb = Tables<kShared>{smat, slight, sframe};
  }
  const int tiles = (p.n + TILE - 1) / TILE;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int t0 = tile * TILE;
    const int cnt = tt::list_tile<ROUNDS>(
        t0, min(TILE, p.n - t0), list, counts,
        [&](int i) { return io.active[i] != 0; },
        [&](int i) { dead_lane(io, p, i); });
    for (int k = threadIdx.x; k < cnt; k += blockDim.x)
      shade_lane<kShared>(io, p, tb, list[k]);
    __syncthreads();  // the next tile rewrites list and counts
  }
}

tt::SharedFit g_fit;

}  // namespace

extern "C" int tt_shade_scatter(const ShadeIO* io, ShadeParams* prm,
                                void* stream) {
  ShadeParams& p = *prm;
  if (p.exact_atlas || (p.has_sky && !io->sky) ||
      (p.sphere_uv && (!io->mat_pair || !p.has_pair)))
    return (int)cudaErrorNotSupported;
  const size_t tables =
      sizeof(float) * (size_t)(p.M * MAT_COLS + p.L * 6 + p.Q * FRAME_COLS);
  const tt::SharedFit& fit =
      tt::fit_shared(g_fit, tables, tt::LANE_THREADS,
                     shade_scatter_kernel<true>, shade_scatter_kernel<false>);
  p.blocks = tt::lane_blocks(fit.blocks, p.n, TILE);
  p.shared_tables = fit.fits ? 1 : 0;
  if (fit.fits)
    shade_scatter_kernel<true><<<p.blocks, tt::LANE_THREADS, tables,
                                 (cudaStream_t)stream>>>(*io, p);
  else
    shade_scatter_kernel<false><<<p.blocks, tt::LANE_THREADS, 0,
                                  (cudaStream_t)stream>>>(*io, p);
  return (int)cudaGetLastError();
}
