// Native BGU (Bilateral Guided Upsampling) fitter.
//
// Replaces the reference's MATLAB-compiled BGU.exe (invoked via
// os.system at ReHistoGAN/rehistoGAN.py:1139-1141) with an in-process
// solver. Math identical to upsampling/bguFit.m:74-281: weighted
// least-squares fit of an affine bilateral grid with spatial first-
// derivative and intensity second-derivative smoothness.
//
// Solver: matrix-free Jacobi-preconditioned conjugate gradient on the
// normal equations. The data operator S (trilinear slice + affine
// apply) touches exactly 8*(I+1) grid cells per pixel, so S v / S^T u
// are simple gather/scatter passes; the smoothness term is a stencil.
// No sparse matrix is ever assembled.
//
// C ABI only (loaded via ctypes). Layout conventions:
//   images: row-major (H, W, C) doubles
//   gamma:  (gh, gw, gd, n_out, n_in) doubles, C order
// Internally the solve uses voxel index ((i*gd + z)*gw + x)*gh + y per
// output channel (matching histogan_tpu_torch/post/bgu.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PixelStamp {
  // 8 corner voxel offsets (within one (gh*gw*gd) slab) and weights
  int32_t corner[8];
  double weight[8];
  int n;  // valid corners
};

// Build per-pixel trilinear stamps (buildAffineSliceMatrix.m:17-101).
void build_stamps(const double* edge, int h, int w, int gh, int gw, int gd,
                  std::vector<PixelStamp>& stamps) {
  stamps.resize(static_cast<size_t>(h) * w);
  for (int py = 0; py < h; ++py) {
    const double cy = (py + 0.5) * (gh - 1) / h;
    const int y0 = static_cast<int>(std::floor(cy));
    const double dy = cy - y0;
    for (int px = 0; px < w; ++px) {
      const double cx = (px + 0.5) * (gw - 1) / w;
      const int x0 = static_cast<int>(std::floor(cx));
      const double dx = cx - x0;
      const double cz = edge[py * w + px] * (gd - 1);
      const int z0 = static_cast<int>(std::floor(cz));
      const double dz = cz - z0;

      PixelStamp& st = stamps[static_cast<size_t>(py) * w + px];
      st.n = 0;
      for (int c = 0; c < 8; ++c) {
        const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
        const int xi = x0 + ox, yi = y0 + oy, zi = z0 + oz;
        if (xi < 0 || xi >= gw || yi < 0 || yi >= gh || zi < 0 || zi >= gd)
          continue;  // pruned, like the reference
        const double wgt = (ox ? dx : 1 - dx) * (oy ? dy : 1 - dy) *
                           (oz ? dz : 1 - dz);
        st.corner[st.n] = (zi * gw + xi) * gh + yi;
        st.weight[st.n] = wgt;
        ++st.n;
      }
    }
  }
}

// y += S^T W S x for one output channel, where S x per pixel p is
// sum_i in1[p,i] * trilerp(slab_i; p).
void normal_data_apply(const std::vector<PixelStamp>& stamps,
                       const double* in1,   // (P, n_in)
                       const double* wgt,   // (P,) or nullptr
                       int n_in, int slab, const double* x, double* y,
                       std::vector<double>& sx /* scratch (P) */) {
  const size_t P = stamps.size();
  for (size_t p = 0; p < P; ++p) {
    const PixelStamp& st = stamps[p];
    double acc = 0.0;
    for (int i = 0; i < n_in; ++i) {
      const double xi_in = in1[p * n_in + i];
      const double* slab_x = x + static_cast<size_t>(i) * slab;
      double t = 0.0;
      for (int c = 0; c < st.n; ++c) t += st.weight[c] * slab_x[st.corner[c]];
      acc += xi_in * t;
    }
    sx[p] = (wgt ? wgt[p] : 1.0) * acc;
  }
  for (size_t p = 0; p < P; ++p) {
    const PixelStamp& st = stamps[p];
    const double s = sx[p];
    for (int i = 0; i < n_in; ++i) {
      const double f = s * in1[p * n_in + i];
      double* slab_y = y + static_cast<size_t>(i) * slab;
      for (int c = 0; c < st.n; ++c) slab_y[st.corner[c]] += st.weight[c] * f;
    }
  }
}

// y += (A_reg^T A_reg) x for the smoothness terms, per slab (all n_in
// slabs). Index layout within a slab: ((z*gw + x)*gh + y).
struct RegParams {
  int gh, gw, gd, n_in;
  double cy2, cx2, cz2;  // squared row scales
};

inline size_t vox(const RegParams& rp, int i, int z, int x, int y) {
  return ((static_cast<size_t>(i) * rp.gd + z) * rp.gw + x) * rp.gh + y;
}

void normal_reg_apply(const RegParams& rp, const double* x, double* y) {
  const int gh = rp.gh, gw = rp.gw, gd = rp.gd;
  for (int i = 0; i < rp.n_in; ++i) {
    // d/dy rows: for each (z, x, y<gh-1): r = x[y+1]-x[y]
    for (int z = 0; z < gd; ++z)
      for (int xx = 0; xx < gw; ++xx)
        for (int yy = 0; yy + 1 < gh; ++yy) {
          const size_t a = vox(rp, i, z, xx, yy), b = a + 1;
          const double r = rp.cy2 * (x[b] - x[a]);
          y[a] -= r;
          y[b] += r;
        }
    // d/dx rows
    for (int z = 0; z < gd; ++z)
      for (int xx = 0; xx + 1 < gw; ++xx)
        for (int yy = 0; yy < gh; ++yy) {
          const size_t a = vox(rp, i, z, xx, yy), b = vox(rp, i, z, xx + 1, yy);
          const double r = rp.cx2 * (x[b] - x[a]);
          y[a] -= r;
          y[b] += r;
        }
    // z second derivative, interior: r = x[z] - 2 x[z+1] + x[z+2]
    for (int z = 0; z + 2 < gd; ++z)
      for (int xx = 0; xx < gw; ++xx)
        for (int yy = 0; yy < gh; ++yy) {
          const size_t a = vox(rp, i, z, xx, yy);
          const size_t b = vox(rp, i, z + 1, xx, yy);
          const size_t c = vox(rp, i, z + 2, xx, yy);
          const double r = rp.cz2 * (x[a] - 2 * x[b] + x[c]);
          y[a] += r;
          y[b] -= 2 * r;
          y[c] += r;
        }
    // z boundary first-derivative rows (buildSecondDerivZMatrix.m)
    for (int xx = 0; xx < gw; ++xx)
      for (int yy = 0; yy < gh; ++yy) {
        {
          const size_t a = vox(rp, i, 0, xx, yy), b = vox(rp, i, 1, xx, yy);
          const double r = rp.cz2 * (x[b] - x[a]);
          y[a] -= r;
          y[b] += r;
        }
        {
          const size_t a = vox(rp, i, gd - 2, xx, yy);
          const size_t b = vox(rp, i, gd - 1, xx, yy);
          const double r = rp.cz2 * (x[a] - x[b]);
          y[a] += r;
          y[b] -= r;
        }
      }
  }
}

// Diagonal of the normal operator (Jacobi preconditioner).
void normal_diag(const std::vector<PixelStamp>& stamps, const double* in1,
                 const double* wgt, int n_in, int slab, const RegParams& rp,
                 double* diag) {
  const size_t n = static_cast<size_t>(slab) * n_in;
  std::memset(diag, 0, n * sizeof(double));
  const size_t P = stamps.size();
  for (size_t p = 0; p < P; ++p) {
    const PixelStamp& st = stamps[p];
    const double wp = wgt ? wgt[p] : 1.0;
    for (int i = 0; i < n_in; ++i) {
      const double xi_in = in1[p * n_in + i];
      double* slab_d = diag + static_cast<size_t>(i) * slab;
      for (int c = 0; c < st.n; ++c) {
        const double s = st.weight[c] * xi_in;
        slab_d[st.corner[c]] += wp * s * s;
      }
    }
  }
  const int gh = rp.gh, gw = rp.gw, gd = rp.gd;
  for (int i = 0; i < rp.n_in; ++i) {
    for (int z = 0; z < gd; ++z)
      for (int xx = 0; xx < gw; ++xx)
        for (int yy = 0; yy < gh; ++yy) {
          const size_t a = vox(rp, i, z, xx, yy);
          double d = 0.0;
          // y-derivative rows touching a
          if (yy + 1 < gh) d += rp.cy2;
          if (yy > 0) d += rp.cy2;
          if (xx + 1 < gw) d += rp.cx2;
          if (xx > 0) d += rp.cx2;
          // z second-derivative rows: coefficient at offset position
          for (int z0 = z - 2; z0 <= z; ++z0) {
            if (z0 < 0 || z0 + 2 >= gd) continue;
            const int off = z - z0;
            const double coef = (off == 1) ? -2.0 : 1.0;
            d += rp.cz2 * coef * coef;
          }
          // boundary rows
          if (z == 0 || z == 1) d += rp.cz2;
          if (z == gd - 2 || z == gd - 1) d += rp.cz2;
          diag[a] += d;
        }
  }
}

}  // namespace

extern "C" {

// Fit gamma for all output channels.
// input_ds: (h, w, n_in-1); edge_ds: (h, w); output_ds: (h, w, n_out);
// weight_ds: (h, w) or nullptr; gamma out: (gh, gw, gd, n_out, n_in).
// Returns the number of CG iterations of the last channel, or -1 on error.
int bgu_fit_native(const double* input_ds, const double* edge_ds,
                   const double* output_ds, const double* weight_ds,
                   int h, int w, int in_ch, int n_out,
                   int gh, int gw, int gd,
                   double lambda_spatial, double lambda_z,
                   int max_iters, double tol, double* gamma_out) {
  const int n_in = in_ch + 1;
  const int slab = gh * gw * gd;
  const size_t n = static_cast<size_t>(slab) * n_in;
  const size_t P = static_cast<size_t>(h) * w;

  std::vector<PixelStamp> stamps;
  build_stamps(edge_ds, h, w, gh, gw, gd, stamps);

  // input with ones channel appended
  std::vector<double> in1(P * n_in);
  for (size_t p = 0; p < P; ++p) {
    for (int i = 0; i < in_ch; ++i) in1[p * n_in + i] = input_ds[p * in_ch + i];
    in1[p * n_in + in_ch] = 1.0;
  }

  const double bin_x = static_cast<double>(w) / gw;
  const double bin_y = static_cast<double>(h) / gh;
  const double bin_z = 1.0 / gd;
  RegParams rp;
  rp.gh = gh; rp.gw = gw; rp.gd = gd; rp.n_in = n_in;
  const double cy = (bin_x * bin_z / bin_y) * lambda_spatial;
  const double cx = (bin_y * bin_z / bin_x) * lambda_spatial;
  const double cz = (bin_x * bin_y) / (bin_z * bin_z) * lambda_z;
  rp.cy2 = cy * cy; rp.cx2 = cx * cx; rp.cz2 = cz * cz;

  std::vector<double> diag(n);
  normal_diag(stamps, in1.data(), weight_ds, n_in, slab, rp, diag.data());
  for (size_t k = 0; k < n; ++k)
    if (diag[k] <= 0) diag[k] = 1.0;

  std::vector<double> x(n), r(n), z(n), pvec(n), ap(n), rhs(n), sx(P);
  int last_iters = -1;

  for (int o = 0; o < n_out; ++o) {
    // rhs = S^T W y_o
    std::fill(rhs.begin(), rhs.end(), 0.0);
    for (size_t p = 0; p < P; ++p) {
      const PixelStamp& st = stamps[p];
      const double wp = weight_ds ? weight_ds[p] : 1.0;
      const double yv = wp * output_ds[p * n_out + o];
      for (int i = 0; i < n_in; ++i) {
        const double f = yv * in1[p * n_in + i];
        double* slab_r = rhs.data() + static_cast<size_t>(i) * slab;
        for (int c = 0; c < st.n; ++c)
          slab_r[st.corner[c]] += st.weight[c] * f;
      }
    }

    // PCG
    std::fill(x.begin(), x.end(), 0.0);
    r = rhs;
    double rhs_norm = 0.0;
    for (size_t k = 0; k < n; ++k) rhs_norm += rhs[k] * rhs[k];
    rhs_norm = std::sqrt(rhs_norm);
    if (rhs_norm == 0.0) rhs_norm = 1.0;

    for (size_t k = 0; k < n; ++k) z[k] = r[k] / diag[k];
    pvec = z;
    double rz = 0.0;
    for (size_t k = 0; k < n; ++k) rz += r[k] * z[k];

    int it = 0;
    for (; it < max_iters; ++it) {
      std::fill(ap.begin(), ap.end(), 0.0);
      normal_data_apply(stamps, in1.data(), weight_ds, n_in, slab,
                        pvec.data(), ap.data(), sx);
      normal_reg_apply(rp, pvec.data(), ap.data());
      double pap = 0.0;
      for (size_t k = 0; k < n; ++k) pap += pvec[k] * ap[k];
      if (pap <= 0) break;
      const double alpha = rz / pap;
      double rnorm = 0.0;
      for (size_t k = 0; k < n; ++k) {
        x[k] += alpha * pvec[k];
        r[k] -= alpha * ap[k];
        rnorm += r[k] * r[k];
      }
      if (std::sqrt(rnorm) < tol * rhs_norm) { ++it; break; }
      for (size_t k = 0; k < n; ++k) z[k] = r[k] / diag[k];
      double rz_new = 0.0;
      for (size_t k = 0; k < n; ++k) rz_new += r[k] * z[k];
      const double beta = rz_new / rz;
      rz = rz_new;
      for (size_t k = 0; k < n; ++k) pvec[k] = z[k] + beta * pvec[k];
    }
    last_iters = it;

    // write gamma[:, :, :, o, i] from x slabs (slab layout z-major,
    // within-slab ((z*gw + x)*gh + y))
    for (int i = 0; i < n_in; ++i) {
      const double* slab_x = x.data() + static_cast<size_t>(i) * slab;
      for (int zz = 0; zz < gd; ++zz)
        for (int xx = 0; xx < gw; ++xx)
          for (int yy = 0; yy < gh; ++yy) {
            const size_t src = (static_cast<size_t>(zz) * gw + xx) * gh + yy;
            const size_t dst =
                (((static_cast<size_t>(yy) * gw + xx) * gd + zz) * n_out + o) *
                    n_in + i;
            gamma_out[dst] = slab_x[src];
          }
    }
  }
  return last_iters;
}

// Slice + apply at full resolution (bguSlice.m:24-69).
void bgu_slice_native(const double* gamma, int gh, int gw, int gd,
                      int n_out, int n_in, const double* input_fs,
                      const double* edge_fs, int h, int w, double* out) {
  const int in_ch = n_in - 1;
  for (int py = 0; py < h; ++py) {
    double cy = (py + 0.5) * (gh - 1) / h;
    int y0 = static_cast<int>(std::floor(cy));
    if (y0 > gh - 2) y0 = gh - 2;
    if (y0 < 0) y0 = 0;
    const double fy = cy - y0;
    for (int px = 0; px < w; ++px) {
      double cx = (px + 0.5) * (gw - 1) / w;
      int x0 = static_cast<int>(std::floor(cx));
      if (x0 > gw - 2) x0 = gw - 2;
      if (x0 < 0) x0 = 0;
      const double fx = cx - x0;
      double e = edge_fs[py * w + px];
      if (e < 0) e = 0;
      if (e > 1) e = 1;
      const double cz = e * (gd - 1);
      int z0 = static_cast<int>(std::floor(cz));
      if (z0 > gd - 2) z0 = gd - 2;
      if (z0 < 0) z0 = 0;
      const double fz = cz - z0;

      for (int o = 0; o < n_out; ++o) {
        double val = 0.0;
        for (int i = 0; i < n_in; ++i) {
          double m = 0.0;
          for (int c = 0; c < 8; ++c) {
            const int ox = c & 1, oy = (c >> 1) & 1, oz = (c >> 2) & 1;
            const double wgt = (ox ? fx : 1 - fx) * (oy ? fy : 1 - fy) *
                               (oz ? fz : 1 - fz);
            // A grid one cell wide (gh, gw or gd of 1) puts the far corner
            // outside the grid with weight 0; it reads the last cell, as
            // numpy's wrapped index does in bgu.py, never past the array
            // (0 times an arbitrary double may be NaN).
            const int yi = y0 + oy < gh ? y0 + oy : gh - 1;
            const int xi = x0 + ox < gw ? x0 + ox : gw - 1;
            const int zi = z0 + oz < gd ? z0 + oz : gd - 1;
            const size_t idx =
                ((((static_cast<size_t>(yi) * gw + xi) * gd + zi) * n_out + o) *
                 n_in) + i;
            m += wgt * gamma[idx];
          }
          const double xin =
              (i < in_ch) ? input_fs[(static_cast<size_t>(py) * w + px) * in_ch + i]
                          : 1.0;
          val += m * xin;
        }
        out[(static_cast<size_t>(py) * w + px) * n_out + o] = val;
      }
    }
  }
}

}  // extern "C"
