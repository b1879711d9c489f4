// Device code shared by the warp + NCC kernels (allview_ncc.cu, slot_ncc.cu),
// the row-wise NCC kernel (ncc_pairs.cu, which takes `warp_sum`) and the
// window kernels (window_ncc.cu, window_textures.cu, which take the block
// shape and `block_sum2`).
//
// `score_row` is the whole body of the two warp + NCC kernels: one warp
// scores one patch against a list of entries (allview_ncc.cu: the V views of
// a visibility row; slot_ncc.cu: the M view slots of a slot table), which
// differ only in how an entry names its view and which entry is the anchor.
// A warp never waits for another: there is no block barrier, and a block is
// just kRowWarps patches.
//
//   1. Set-up, once per (patch, entry), four lanes per entry: the patch frame
//      (sx, sy) from position, normal and the reference camera, exactly as
//      `ops.warp.patch_frames` defines it; the entry's camera; the strict
//      4-corner bounds test through the decomposed projection K (R (X - C)),
//      a corner per lane; and the texel homography, a column per lane.
//      Texel (r, c) of the k x k texture lies at
//      X = p + (2c/k - 1) sx + (2r/k - 1) sy, which is affine in (c, r), so
//      its homogeneous pixel is A + c B + r Cc with A = K (R (p - sx - sy -
//      C)), B = K (R (2 sx / k)), Cc = K (R (2 sy / k)). The columns are
//      formed in f64 and stored relative to the pixel (ox, oy) of the patch
//      centre:  px = ox + (a0 + c b0 + r c0) / (A2 + c B2 + r C2),  whose
//      quotient is a few pixels, so the f32 pixel carries one rounding at
//      its own magnitude (what a pixel near 1600 can hold at all) and none
//      of the roundings of a projection at magnitude |K R (X - C)|.
//      Ballots over the flags give the anchor and the live entries
//      (flagged, corners inside, not the anchor) as bit masks in the warp's
//      shared memory; the lanes write the -1 sentinel of every other entry.
//   2. The anchor texture: a lane holds T = ceil(k k / 32) texels in
//      registers, loads all 4 T taps before it blends any, and keeps its
//      texels centred in registers.
//   3. The live entries one after another, each texture sampled the same
//      way into the same lanes, so mean, centred variance and covariance
//      against the anchor come from registers and warp shuffles only; lane 0
//      writes the score. Textures above 256 texels take a strided variant
//      that keeps the anchor in shared memory and samples a view twice.
//
// The bilinear sample clamps x to [0, W-1] and x0 to [0, W-2] against the
// (padded) stack size, in f32; offsets inside a view's page are 32-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_ncc {

// Block shape of the kernels that reduce over a block (`block_sum2`: the
// window kernels).
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Patches of one block of a warp + NCC kernel, a warp each, and the blocks
// an SM must be able to hold: 28 warps at 72 registers a thread. The taps of
// a DRAM-sized stack want the warps more than the registers.
constexpr int kRowWarps = 4;
constexpr int kRowBlocks = 7;
constexpr unsigned kFullMask = 0xffffffffu;
// Per entry in shared memory: ox, oy, a0, b0, c0, a1, b1, c1, A2, B2, C2 and
// the view id.
constexpr int kEntryWords = 12;

struct View {
  float K[9];
  float R[9];
  float C[3];
  float w, h;
};

// Camera v; `E` holds the (3, 4) extrinsics [R | -R C] of every view.
__device__ __forceinline__ void load_view(View& cam, const float* K,
                                          const float* E, const float* C,
                                          const int* width, const int* height,
                                          int v) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      cam.K[i * 3 + j] = K[v * 9 + i * 3 + j];
      cam.R[i * 3 + j] = E[v * 12 + i * 4 + j];
    }
    cam.C[i] = C[v * 3 + i];
  }
  cam.w = (float)width[v];
  cam.h = (float)height[v];
}

// pix = K (R (X - C)), dehomogenized.
__device__ __forceinline__ void project(const View& cam, float x, float y,
                                       float z, float& px, float& py) {
  const float r0 = x - cam.C[0], r1 = y - cam.C[1], r2 = z - cam.C[2];
  const float c0 = cam.R[0] * r0 + cam.R[1] * r1 + cam.R[2] * r2;
  const float c1 = cam.R[3] * r0 + cam.R[4] * r1 + cam.R[5] * r2;
  const float c2 = cam.R[6] * r0 + cam.R[7] * r1 + cam.R[8] * r2;
  const float h0 = cam.K[0] * c0 + cam.K[1] * c1 + cam.K[2] * c2;
  const float h1 = cam.K[3] * c0 + cam.K[4] * c1 + cam.K[5] * c2;
  const float h2 = cam.K[6] * c0 + cam.K[7] * c1 + cam.K[8] * c2;
  px = h0 / h2;
  py = h1 / h2;
}

// Strict-bounds test of corner `c` of the 4 corners p -+ sx -+ sy (in the
// order (-,-), (+,-), (+,+), (-,+)) against the view size.
__device__ __forceinline__ bool corner_inside(const View& cam, const float* p,
                                              const float* sx,
                                              const float* sy, int c) {
  const float su = (c == 1 || c == 2) ? 1.f : -1.f;
  const float sv = c >= 2 ? 1.f : -1.f;
  float q[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) q[i] = p[i] + (su * sx[i] + sv * sy[i]);
  float px, py;
  project(cam, q[0], q[1], q[2], px, py);
  return (px > 0.f) && (px < cam.w) && (py > 0.f) && (py < cam.h);
}

// (sx, sy) of a patch: y = n x x_axis (not normalised), both scaled by
// (k / 2) / max(|proj(p + x_axis) - proj(p)|, 1e-12) in the reference view.
__device__ __forceinline__ void patch_frame(const View& ref, const float* xa,
                                            const float* p, const float* nrm,
                                            int k, float* sx, float* sy) {
  const float ya[3] = {nrm[1] * xa[2] - nrm[2] * xa[1],
                       nrm[2] * xa[0] - nrm[0] * xa[2],
                       nrm[0] * xa[1] - nrm[1] * xa[0]};
  float ax, ay, bx, by;
  project(ref, p[0] + xa[0], p[1] + xa[1], p[2] + xa[2], ax, ay);
  project(ref, p[0], p[1], p[2], bx, by);
  const float ux = ax - bx, uy = ay - by;
  const float scale = (float)(k / 2) / fmaxf(sqrtf(ux * ux + uy * uy), 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sx[i] = scale * xa[i];
    sy[i] = scale * ya[i];
  }
}

// h = K (R x) in f64.
__device__ __forceinline__ void rotate_calibrate(const View& cam,
                                                 const double* x, double* h) {
  double c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    c[i] = (double)cam.R[i * 3] * x[0] + (double)cam.R[i * 3 + 1] * x[1] +
           (double)cam.R[i * 3 + 2] * x[2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    h[i] = (double)cam.K[i * 3] * c[0] + (double)cam.K[i * 3 + 1] * c[1] +
           (double)cam.K[i * 3 + 2] * c[2];
}

// The texel homography of one (patch, view), centred on the pixel of the
// patch centre, by the four lanes `group` (a mask of 4 neighbouring lanes,
// all of which must call): lane `sub` = 0, 1, 2 forms column A, B, Cc in
// f64, the origin comes from the columns met by shuffles, and the lanes
// write the 11 floats of the entry and the view id between them.
__device__ __forceinline__ void texel_homography(const View& cam,
                                                 const float* p,
                                                 const float* sx,
                                                 const float* sy, int k,
                                                 unsigned group, int sub,
                                                 int lane, int v,
                                                 float* entry) {
  const double step = 2.0 / (double)k;
  double x[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double o =
        (((double)p[i] - (double)sx[i]) - (double)sy[i]) - (double)cam.C[i];
    x[i] = sub == 0 ? o : (double)(sub == 1 ? sx[i] : sy[i]) * step;
  }
  double col[3];
  rotate_calibrate(cam, x, col);
  // Any pixel near the patch will do as the origin, so the pixel of the
  // patch centre, texel (k/2, k/2) of the affine grid, is taken in f32;
  // what has to be exact is each column's remainder against that origin.
  const float half = 0.5f * (float)k;
  const int first = lane & ~3;
  float m[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float mine = (float)col[i];
    const float a = __shfl_sync(group, mine, first);
    const float b = __shfl_sync(group, mine, first + 1);
    const float c = __shfl_sync(group, mine, first + 2);
    m[i] = a + half * (b + c);
  }
  const float ox = m[0] / m[2];
  const float oy = m[1] / m[2];
  if (sub < 3) {
    entry[2 + sub] = (float)(col[0] - (double)ox * col[2]);
    entry[5 + sub] = (float)(col[1] - (double)oy * col[2]);
    entry[8 + sub] = (float)col[2];
  } else {
    entry[0] = ox;
    entry[1] = oy;
    entry[11] = __int_as_float(v);
  }
}

// Geometry of a view's page and texture that every texel of a row shares.
struct Page {
  int W, H;
  float wm1, hm1;  // (float)(W - 1), (float)(H - 1)
  int k, n;        // texture side and texel count
  float inv_k;
};

// (row, column) of texel i < 78 * 78 as floats: the product below is at
// least 0.5 / k away from an integer, far more than its rounding.
__device__ __forceinline__ void texel_row_col(const Page& pg, int i, float& rf,
                                              float& cf) {
  const int r = __float2int_rd(((float)i + 0.5f) * pg.inv_k);
  rf = (float)r;
  cf = (float)(i - r * pg.k);
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Texel (rf, cf) of a texture through homography `h` (11 floats in
// registers): the bilinear cell's offset inside the page and its two
// weights. The quotient is a few pixels, so the one-ulp reciprocal moves the
// pixel by a few 1e-6 px.
__device__ __forceinline__ void texel_cell(const float* h, const Page& pg,
                                           float rf, float cf, int& off,
                                           float& dx, float& dy) {
  const float inv = rcp_approx(fmaf(rf, h[10], fmaf(cf, h[9], h[8])));
  float px = fmaf(fmaf(rf, h[4], fmaf(cf, h[3], h[2])), inv, h[0]);
  float py = fmaf(fmaf(rf, h[7], fmaf(cf, h[6], h[5])), inv, h[1]);
  // fmaxf/fminf drop a NaN operand, so a degenerate projection clamps to 0.
  px = fminf(fmaxf(px, 0.f), pg.wm1);
  py = fminf(fmaxf(py, 0.f), pg.hm1);
  // px >= 0 already, so the cell's corner only needs its upper clamp.
  const int x0 = min(__float2int_rd(px), pg.W - 2);
  const int y0 = min(__float2int_rd(py), pg.H - 2);
  dx = px - (float)x0;
  dy = py - (float)y0;
  off = y0 * pg.W + x0;
}

// The bilinear blend as three interpolations.
__device__ __forceinline__ float blend(float i00, float i01, float i10,
                                       float i11, float dx, float dy) {
  const float top = fmaf(dx, i01 - i00, i00);
  const float bot = fmaf(dx, i11 - i10, i10);
  return fmaf(dy, bot - top, top);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Block-wide sum of two values over kThreads threads; every thread gets
// both totals. Every thread of the block must call it.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* part,
                                             float2* total) {
  a = warp_sum(a);
  b = warp_sum(b);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 s = lane < kWarps ? part[lane] : make_float2(0.f, 0.f);
    s.x = warp_sum(s.x);
    s.y = warp_sum(s.y);
    if (lane == 0) *total = s;
  }
  __syncthreads();
  return *total;
}

__device__ __forceinline__ float ncc_score(float cov, float var, float nf,
                                           float sa) {
  return (cov / nf) / fmaxf(sa * sqrtf(var / nf), 0.1f);
}

// One view's texture into the registers of a whole warp: lane l holds texels
// l, l + 32, ... (T of them, at (rf[j], cf[j])); all 4 T taps are loaded
// before any is blended. Lanes past the texture's end sample texel 0 and
// hold 0. Returns the lane's sum.
template <int T>
__device__ __forceinline__ float warp_texture(const float* img,
                                              const float* entry,
                                              const Page& pg, const float* rf,
                                              const float* cf, int lane,
                                              float* tex) {
  float h[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) h[i] = entry[i];
  float t00[T], t01[T], t10[T], t11[T], dx[T], dy[T];
#pragma unroll
  for (int j = 0; j < T; ++j) {
    int off;
    texel_cell(h, pg, rf[j], cf[j], off, dx[j], dy[j]);
    const float* q = img + off;
    t00[j] = __ldg(q);
    t01[j] = __ldg(q + 1);
    t10[j] = __ldg(q + pg.W);
    t11[j] = __ldg(q + pg.W + 1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float t = blend(t00[j], t01[j], t10[j], t11[j], dx[j], dy[j]);
    tex[j] = lane + 32 * j < pg.n ? t : 0.f;
    s += tex[j];
  }
  return s;
}

// The same texel by texel for a texture of any size (nothing is held).
__device__ __forceinline__ float sample_texel(const float* img,
                                              const float* h, const Page& pg,
                                              int i) {
  float rf, cf, dx, dy;
  int off;
  texel_row_col(pg, i, rf, cf);
  texel_cell(h, pg, rf, cf, off, dx, dy);
  const float* q = img + off;
  return blend(__ldg(q), __ldg(q + 1), __ldg(q + pg.W), __ldg(q + pg.W + 1),
               dx, dy);
}

// What every launch of a warp + NCC kernel carries.
struct Scene {
  const float* images;  // (V, H, W)
  int V, H, W;
  const float* K;       // (V, 3, 3)
  const float* E;       // (V, 3, 4)
  const float* C;       // (V, 3)
  const float* x_axis;  // (V, 3)
  const int* width;     // (V,)
  const int* height;    // (V,)
  const float* position;  // (B, 3)
  const float* normal;    // (B, 3)
  const int64_t* ref;     // (B,)
  int64_t B;
  int k;
};

// Texels a lane holds in registers, T = ceil(k k / 32) rounded up to a power
// of two, for textures of up to 256 texels; 0 = the strided variant.
__host__ __device__ inline int texels_per_lane(int k) {
  const int n = k * k;
  return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : n <= 256 ? 8 : 0;
}

// Shared memory of one warp, in 4-byte words: its entries, two bit masks
// (flagged, corners inside) of one bit per entry, and for the strided
// variant the centred anchor texture.
__host__ __device__ inline int mask_words(int count) {
  return (count + 31) / 32;
}
__host__ __device__ inline size_t row_smem_words(int k, int count) {
  return (size_t)count * kEntryWords + 2 * mask_words(count) +
         (texels_per_lane(k) == 0 ? (size_t)k * k : 0);
}

// Scores patch b against its entries, by one whole warp. `Entries` gives
// `count()`, `flagged(e)`, `view(e)` and `kSlots`: false = the anchor is the
// first flagged entry and scores -1 itself (a visibility row); true = the
// anchor is entry 0, or nobody if it is not flagged, and scores against
// itself (a slot table). `anchor_out` / `anchor_ok_out` may be null.
// T = ceil(k k / 32) texels per lane, or 0 for the strided variant.
template <int T, class Entries>
__device__ __forceinline__ void score_row(const Scene& sc, int64_t b,
                                          const Entries& ent, float* srow,
                                          int64_t* anchor_out,
                                          uint8_t* anchor_ok_out,
                                          float* smem) {
  const int count = ent.count();
  const int words = mask_words(count);
  Page pg;
  pg.W = sc.W;
  pg.H = sc.H;
  pg.wm1 = (float)(sc.W - 1);
  pg.hm1 = (float)(sc.H - 1);
  pg.k = sc.k;
  pg.n = sc.k * sc.k;
  pg.inv_k = 1.f / (float)sc.k;
  float* entries = smem;
  unsigned* flagged = reinterpret_cast<unsigned*>(entries + count * kEntryWords);
  unsigned* inside = flagged + words;
  float* ca_strided = reinterpret_cast<float*>(inside + words);
  const int lane = threadIdx.x & 31;

  // 1. Set-up, four lanes per entry and eight entries per pass: lane `sub`
  // tests corner `sub` and forms one column of the homography.
  const int sub = lane & 3;
  const unsigned group = 0xFu << (lane & ~3);
  float p[3], sx[3], sy[3];
  {
    float nrm[3], xa[3];
    int64_t r = sc.ref[b];
    r = r < 0 ? 0 : (r >= sc.V ? sc.V - 1 : r);
    View ref;
    load_view(ref, sc.K, sc.E, sc.C, sc.width, sc.height, (int)r);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] = sc.position[b * 3 + i];
      nrm[i] = sc.normal[b * 3 + i];
      xa[i] = sc.x_axis[r * 3 + i];
    }
    patch_frame(ref, xa, p, nrm, sc.k, sx, sy);
  }
  // A pass writes one byte of each mask; the last word's other bytes are 0.
  if (lane < 2 * words) flagged[lane] = 0u;
  for (int w = 32 + lane; w < 2 * words; w += 32) flagged[w] = 0u;
  __syncwarp();
  uint8_t* flagged_bytes = reinterpret_cast<uint8_t*>(flagged);
  uint8_t* inside_bytes = reinterpret_cast<uint8_t*>(inside);
  for (int e0 = 0; e0 < count; e0 += 8) {
    const int e = e0 + (lane >> 2);
    const bool flag = e < count && ent.flagged(e);
    View cam;
    int v = 0;
    bool ok = false;
    if (flag) {
      v = ent.view(e);
      load_view(cam, sc.K, sc.E, sc.C, sc.width, sc.height, v);
      ok = corner_inside(cam, p, sx, sy, sub);
    }
    const unsigned corners = __ballot_sync(kFullMask, ok);
    ok = ((corners >> (lane & ~3)) & 0xFu) == 0xFu;  // all four inside
    if (ok)
      texel_homography(cam, p, sx, sy, sc.k, group, sub, lane, v,
                       entries + e * kEntryWords);
    // Bits 0, 4, ..., 28 of the ballots are this pass's 8 entries.
    const unsigned fb = __ballot_sync(kFullMask, flag);
    const unsigned ib = __ballot_sync(kFullMask, ok);
    if (lane == 0) {
      unsigned f = 0, g = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        f |= ((fb >> (4 * j)) & 1u) << j;
        g |= ((ib >> (4 * j)) & 1u) << j;
      }
      flagged_bytes[e0 >> 3] = (uint8_t)f;
      inside_bytes[e0 >> 3] = (uint8_t)g;
    }
  }
  __syncwarp();

  // Everything below branches on shared memory only: uniform in the warp.
  int anchor = -1;
  if (Entries::kSlots) {
    anchor = (flagged[0] & 1u) ? 0 : -1;
  } else {
    for (int w = 0; w < words; ++w) {
      const unsigned m = flagged[w];
      if (m) {
        anchor = w * 32 + __ffs(m) - 1;
        break;
      }
    }
  }
  const bool aok =
      anchor >= 0 && ((inside[anchor >> 5] >> (anchor & 31)) & 1u);
  for (int e = lane; e < count; e += 32) {
    const bool live = aok && e != anchor && ((inside[e >> 5] >> (e & 31)) & 1u);
    const bool self = Entries::kSlots && aok && e == anchor;
    if (!live && !self) srow[e] = -1.f;
  }
  if (lane == 0 && anchor_out) {
    *anchor_out = anchor < 0 ? 0 : anchor;
    *anchor_ok_out = aok ? 1 : 0;
  }
  if (!aok) return;

  // 2. The anchor texture, centred: in the registers that hold the same
  // texels of every view later (in shared memory for the strided variant).
  const size_t page = (size_t)sc.H * (size_t)sc.W;
  const float nf = (float)pg.n;
  constexpr int kRegs = T > 0 ? T : 1;
  float rf[kRegs], cf[kRegs], ca[kRegs];
  float sa;
  {
    const float* entry = entries + anchor * kEntryWords;
    const float* img = sc.images + (size_t)__float_as_int(entry[11]) * page;
    if constexpr (T > 0) {
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const int i = lane + 32 * j;
        texel_row_col(pg, i < pg.n ? i : 0, rf[j], cf[j]);
      }
      const float s = warp_texture<T>(img, entry, pg, rf, cf, lane, ca);
      const float mean = warp_sum(s) / nf;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < T; ++j) {
        ca[j] = lane + 32 * j < pg.n ? ca[j] - mean : 0.f;
        q += ca[j] * ca[j];
      }
      sa = sqrtf(warp_sum(q) / nf);
    } else {
      float h[11];
#pragma unroll
      for (int i = 0; i < 11; ++i) h[i] = entry[i];
      float s = 0.f;
      for (int i = lane; i < pg.n; i += 32) {
        const float t = sample_texel(img, h, pg, i);
        ca_strided[i] = t;
        s += t;
      }
      const float mean = warp_sum(s) / nf;
      float q = 0.f;
      for (int i = lane; i < pg.n; i += 32) {
        const float d = ca_strided[i] - mean;
        ca_strided[i] = d;
        q += d * d;
      }
      sa = sqrtf(warp_sum(q) / nf);
    }
    // The anchor against itself: covariance == variance == sa * sa.
    if (Entries::kSlots && lane == 0)
      srow[anchor] = (sa * sa) / fmaxf(sa * sa, 0.1f);
  }

  // 3. The live entries in turn, every tap of a texture in flight at once.
  for (int w = 0; w < words; ++w) {
    unsigned m = inside[w];
    if ((anchor >> 5) == w) m &= ~(1u << (anchor & 31));
    while (m) {
      const int e = w * 32 + __ffs(m) - 1;
      m &= m - 1;
      const float* entry = entries + e * kEntryWords;
      const float* img = sc.images + (size_t)__float_as_int(entry[11]) * page;
      float var = 0.f, cov = 0.f;
      if constexpr (T > 0) {
        float tex[T];
        const float s = warp_texture<T>(img, entry, pg, rf, cf, lane, tex);
        const float mean = warp_sum(s) / nf;
#pragma unroll
        for (int j = 0; j < T; ++j) {
          // ca is 0 past the texture's end; the variance needs the mask.
          const float d = lane + 32 * j < pg.n ? tex[j] - mean : 0.f;
          var = fmaf(d, d, var);
          cov = fmaf(d, ca[j], cov);
        }
      } else {
        // Two sampling passes; the second finds its taps in L1.
        float h[11];
#pragma unroll
        for (int i = 0; i < 11; ++i) h[i] = entry[i];
        float s = 0.f;
        for (int i = lane; i < pg.n; i += 32) s += sample_texel(img, h, pg, i);
        const float mean = warp_sum(s) / nf;
        for (int i = lane; i < pg.n; i += 32) {
          const float d = sample_texel(img, h, pg, i) - mean;
          var = fmaf(d, d, var);
          cov = fmaf(d, ca_strided[i], cov);
        }
      }
      const float score = ncc_score(warp_sum(cov), warp_sum(var), nf, sa);
      if (lane == 0) srow[e] = score;
    }
  }
}

}  // namespace warp_ncc
