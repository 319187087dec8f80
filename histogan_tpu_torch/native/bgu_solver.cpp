// Native BGU (Bilateral Guided Upsampling) fitter.
//
// Replaces the reference's MATLAB-compiled BGU.exe (invoked via
// os.system at ReHistoGAN/rehistoGAN.py:1139-1141) with an in-process
// solver. Math identical to upsampling/bguFit.m:74-281: weighted
// least-squares fit of an affine bilateral grid with spatial first-
// derivative and intensity second-derivative smoothness.
//
// Solver: conjugate gradient on the normal equations, preconditioned by
// the operator's n_in x n_in block at each grid vertex (block-Jacobi, each
// block factored once by Cholesky). The data term S^T W S couples a vertex
// only with its 26 neighbours, so it is assembled once as a 27-point
// stencil of n_in x n_in blocks; the smoothness term is applied as its own
// stencil. The operator is the same for every output channel: it is built
// and factored once. Each channel reports its iterations, its final
// relative residual and whether it reached tol; the caller decides what an
// unconverged fit means.
//
// C ABI only (loaded via ctypes). Layout conventions:
//   images: row-major (H, W, C) doubles
//   gamma:  (gh, gw, gd, n_out, n_in) doubles, C order
// Internally a grid vertex is v = (z*gw + x)*gh + y (the voxel order of
// histogan_tpu_torch/post/bgu.py) and the solve's unknown for coefficient
// i of vertex v sits at v*n_in + i.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct PixelStamp {
  // 8 corner voxel offsets (within one (gh*gw*gd) slab), their corner
  // codes (bit 0: +x, bit 1: +y, bit 2: +z) and weights
  int32_t corner[8];
  int8_t code[8];
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
        st.code[st.n] = static_cast<int8_t>(c);
        st.weight[st.n] = wgt;
        ++st.n;
      }
    }
  }
}

struct Grid {
  int gh, gw, gd, n_in;
  double cy2, cx2, cz2;  // squared smoothness row scales
  int slab() const { return gh * gw * gd; }
  size_t vertex(int z, int x, int y) const {
    return (static_cast<size_t>(z) * gw + x) * gh + y;
  }
};

constexpr int kStencil = 27;  // offsets (dz, dx, dy) in {-1, 0, 1}^3
constexpr int kCenter = 13;

inline int stencil_index(int dz, int dx, int dy) {
  return ((dz + 1) * 3 + (dx + 1)) * 3 + (dy + 1);
}

// The data term S^T W S as a stencil: blocks (slab, 27, n_in, n_in), the
// block at (v, offset) multiplying the coefficients of vertex v + offset.
// Per pixel, corners a and b of its cell add w_a w_b wp in in^T.
void build_data_stencil(const std::vector<PixelStamp>& stamps, const double* in1,
                        const double* wgt, const Grid& g, double* blocks) {
  const int n_in = g.n_in;
  const size_t nn = static_cast<size_t>(n_in) * n_in;
  std::memset(blocks, 0, static_cast<size_t>(g.slab()) * kStencil * nn * sizeof(double));
  double outer[256];
  const size_t P = stamps.size();
  for (size_t p = 0; p < P; ++p) {
    const PixelStamp& st = stamps[p];
    const double wp = wgt ? wgt[p] : 1.0;
    const double* in_p = in1 + p * n_in;
    for (int i = 0; i < n_in; ++i)
      for (int j = 0; j < n_in; ++j) outer[i * n_in + j] = wp * in_p[i] * in_p[j];
    for (int a = 0; a < st.n; ++a) {
      const int ca = st.code[a];
      double* row = blocks + static_cast<size_t>(st.corner[a]) * kStencil * nn;
      for (int b = 0; b < st.n; ++b) {
        const int cb = st.code[b];
        const int off = stencil_index(((cb >> 2) & 1) - ((ca >> 2) & 1),
                                      (cb & 1) - (ca & 1),
                                      ((cb >> 1) & 1) - ((ca >> 1) & 1));
        const double s = st.weight[a] * st.weight[b];
        double* blk = row + static_cast<size_t>(off) * nn;
        for (size_t k = 0; k < nn; ++k) blk[k] += s * outer[k];
      }
    }
  }
}

// The smoothness term's diagonal at each vertex (the same for every
// coefficient of the vertex).
double reg_diag(const Grid& g, int z, int x, int y) {
  double d = 0.0;
  // y- and x-derivative rows touching the vertex
  if (y + 1 < g.gh) d += g.cy2;
  if (y > 0) d += g.cy2;
  if (x + 1 < g.gw) d += g.cx2;
  if (x > 0) d += g.cx2;
  // z second-derivative rows: coefficient at offset position
  for (int z0 = z - 2; z0 <= z; ++z0) {
    if (z0 < 0 || z0 + 2 >= g.gd) continue;
    const double coef = (z - z0 == 1) ? -2.0 : 1.0;
    d += g.cz2 * coef * coef;
  }
  // boundary rows (buildSecondDerivZMatrix.m)
  if (z == 0 || z == 1) d += g.cz2;
  if (z == g.gd - 2 || z == g.gd - 1) d += g.cz2;
  return d;
}

// y = S^T W S x over the stencil, for m right-hand sides at once (the
// output channels, which share the operator): unknown (v*n_in + i)*m + o.
// NI and M are n_in and m when they are known at compile time, else 0 and
// the runtime values are used. The RGB fit (n_in 4, m 3) runs about three
// times faster with them known (tools/bgu_fit_timing.py; PERF.md).
template <int NI, int M>
void data_apply(const Grid& g, const double* blocks, int n_in_rt, int m_rt,
                const double* x, double* y) {
  const int n_in = NI ? NI : n_in_rt;
  const int m = M ? M : m_rt;
  const size_t nn = static_cast<size_t>(n_in) * n_in;
  const size_t vm = static_cast<size_t>(n_in) * m;  // values per vertex
  double acc[16 * 16];
  for (int z = 0; z < g.gd; ++z)
    for (int xx = 0; xx < g.gw; ++xx)
      for (int yy = 0; yy < g.gh; ++yy) {
        const size_t v = g.vertex(z, xx, yy);
        const double* row = blocks + v * kStencil * nn;
        for (size_t k = 0; k < vm; ++k) acc[k] = 0.0;
        for (int dz = -1; dz <= 1; ++dz) {
          if (z + dz < 0 || z + dz >= g.gd) continue;
          for (int dx = -1; dx <= 1; ++dx) {
            if (xx + dx < 0 || xx + dx >= g.gw) continue;
            for (int dy = -1; dy <= 1; ++dy) {
              if (yy + dy < 0 || yy + dy >= g.gh) continue;
              const double* blk = row + stencil_index(dz, dx, dy) * nn;
              const double* xu = x + g.vertex(z + dz, xx + dx, yy + dy) * vm;
              for (int i = 0; i < n_in; ++i)
                for (int j = 0; j < n_in; ++j) {
                  const double b = blk[i * n_in + j];
                  for (int o = 0; o < m; ++o) acc[i * m + o] += b * xu[j * m + o];
                }
            }
          }
        }
        for (size_t k = 0; k < vm; ++k) y[v * vm + k] = acc[k];
      }
}

// y = (S^T W S + A_reg^T A_reg) x (layout as data_apply's).
void normal_apply(const Grid& g, const double* blocks, int m, const double* x, double* y) {
  const int n_in = g.n_in;
  const size_t vm = static_cast<size_t>(n_in) * m;
#ifndef BGU_RUNTIME_SIZES  // defined only to time the runtime-sized loop
  if (n_in == 4 && m == 3)
    data_apply<4, 3>(g, blocks, n_in, m, x, y);
  else
#endif
    data_apply<0, 0>(g, blocks, n_in, m, x, y);
  // the smoothness rows, each the same for every coefficient and channel
  auto at = [&](int z, int xx, int yy) { return g.vertex(z, xx, yy) * vm; };
  for (int z = 0; z < g.gd; ++z)
    for (int xx = 0; xx < g.gw; ++xx)
      for (int yy = 0; yy < g.gh; ++yy) {
        const size_t a = at(z, xx, yy);
        if (yy + 1 < g.gh) {  // d/dy: r = x[y+1] - x[y]
          const size_t b = at(z, xx, yy + 1);
          for (size_t k = 0; k < vm; ++k) {
            const double r = g.cy2 * (x[b + k] - x[a + k]);
            y[a + k] -= r;
            y[b + k] += r;
          }
        }
        if (xx + 1 < g.gw) {  // d/dx
          const size_t b = at(z, xx + 1, yy);
          for (size_t k = 0; k < vm; ++k) {
            const double r = g.cx2 * (x[b + k] - x[a + k]);
            y[a + k] -= r;
            y[b + k] += r;
          }
        }
        if (z + 2 < g.gd) {  // z second derivative: r = x[z] - 2 x[z+1] + x[z+2]
          const size_t b = at(z + 1, xx, yy), c = at(z + 2, xx, yy);
          for (size_t k = 0; k < vm; ++k) {
            const double r = g.cz2 * (x[a + k] - 2 * x[b + k] + x[c + k]);
            y[a + k] += r;
            y[b + k] -= 2 * r;
            y[c + k] += r;
          }
        }
        // z boundary first-derivative rows (buildSecondDerivZMatrix.m): the
        // first and the last pair of z, both at z = 0 when gd = 2
        const int rows = (z == 0) + (z == g.gd - 2);
        if (rows) {
          const size_t b = at(z + 1, xx, yy);
          for (size_t k = 0; k < vm; ++k) {
            const double r = rows * g.cz2 * (x[b + k] - x[a + k]);
            y[a + k] -= r;
            y[b + k] += r;
          }
        }
      }
}

// Cholesky of each vertex's diagonal block (data + smoothness) into
// factors (slab, n_in, n_in), lower triangle. A block that is not
// numerically positive definite keeps only its diagonal (1 where that is
// not positive).
void factor_blocks(const Grid& g, const double* blocks, double* factors) {
  const int n_in = g.n_in;
  const size_t nn = static_cast<size_t>(n_in) * n_in;
  for (int z = 0; z < g.gd; ++z)
    for (int xx = 0; xx < g.gw; ++xx)
      for (int yy = 0; yy < g.gh; ++yy) {
        const size_t v = g.vertex(z, xx, yy);
        double* b = factors + v * nn;
        std::memcpy(b, blocks + (v * kStencil + kCenter) * nn, nn * sizeof(double));
        const double d_reg = reg_diag(g, z, xx, yy);
        double diag[16], scale = 0.0;
        for (int i = 0; i < n_in; ++i) {
          b[i * n_in + i] += d_reg;
          diag[i] = b[i * n_in + i];
          scale = std::fmax(scale, diag[i]);
        }
        bool ok = scale > 0.0;
        for (int j = 0; ok && j < n_in; ++j) {
          double d = b[j * n_in + j];
          for (int k = 0; k < j; ++k) d -= b[j * n_in + k] * b[j * n_in + k];
          if (!(d > 1e-14 * scale)) { ok = false; break; }
          d = std::sqrt(d);
          b[j * n_in + j] = d;
          for (int i = j + 1; i < n_in; ++i) {
            double s = b[i * n_in + j];
            for (int k = 0; k < j; ++k) s -= b[i * n_in + k] * b[j * n_in + k];
            b[i * n_in + j] = s / d;
          }
        }
        if (!ok) {
          std::memset(b, 0, nn * sizeof(double));
          for (int i = 0; i < n_in; ++i) b[i * n_in + i] = diag[i] > 0.0 ? std::sqrt(diag[i]) : 1.0;
        }
      }
}

// z = B^-1 r, vertex by vertex, from the factored blocks, for m
// right-hand sides (layout as normal_apply's).
void apply_block_inverse(int slab, int n_in, int m, const double* factors,
                         const double* r, double* z) {
  const size_t nn = static_cast<size_t>(n_in) * n_in;
  const size_t vm = static_cast<size_t>(n_in) * m;
  for (int v = 0; v < slab; ++v) {
    const double* l = factors + static_cast<size_t>(v) * nn;
    const double* rv = r + static_cast<size_t>(v) * vm;
    double* t = z + static_cast<size_t>(v) * vm;
    for (int o = 0; o < m; ++o) {
      for (int i = 0; i < n_in; ++i) {  // L t = r
        double s = rv[i * m + o];
        for (int k = 0; k < i; ++k) s -= l[i * n_in + k] * t[k * m + o];
        t[i * m + o] = s / l[i * n_in + i];
      }
      for (int i = n_in - 1; i >= 0; --i) {  // L^T z = t
        double s = t[i * m + o];
        for (int k = i + 1; k < n_in; ++k) s -= l[k * n_in + i] * t[k * m + o];
        t[i * m + o] = s / l[i * n_in + i];
      }
    }
  }
}

}  // namespace

extern "C" {

// Fit gamma for all output channels.
// input_ds: (h, w, n_in-1); edge_ds: (h, w); output_ds: (h, w, n_out);
// weight_ds: (h, w) or nullptr; gamma out: (gh, gw, gd, n_out, n_in).
// Per output channel o: iters_out[o] the CG iterations, residual_out[o]
// the final relative residual |b - A x| / |b| (the recursive one, which CG
// carries), status_out[o] BGU_CONVERGED, BGU_MAX_ITERS (max_iters reached
// above tol) or BGU_NOT_POSITIVE (p.Ap <= 0: the operator is not positive
// definite in floating point; the iterate is then the last good one).
// Returns the largest iteration count over the channels, or -1 on bad
// arguments.
enum { BGU_CONVERGED = 0, BGU_MAX_ITERS = 1, BGU_NOT_POSITIVE = 2 };

int bgu_fit_native(const double* input_ds, const double* edge_ds,
                   const double* output_ds, const double* weight_ds,
                   int h, int w, int in_ch, int n_out,
                   int gh, int gw, int gd,
                   double lambda_spatial, double lambda_z,
                   int max_iters, double tol, double* gamma_out,
                   int* iters_out, double* residual_out, int* status_out) {
  const int n_in = in_ch + 1;
  if (h <= 0 || w <= 0 || in_ch < 0 || n_in > 16 || n_out <= 0 || n_out > 16 || gh <= 0 ||
      gw <= 0 || gd < 2 || max_iters < 0)
    return -1;
  const double bin_x = static_cast<double>(w) / gw;
  const double bin_y = static_cast<double>(h) / gh;
  const double bin_z = 1.0 / gd;
  const double cy = (bin_x * bin_z / bin_y) * lambda_spatial;
  const double cx = (bin_y * bin_z / bin_x) * lambda_spatial;
  const double cz = (bin_x * bin_y) / (bin_z * bin_z) * lambda_z;
  const Grid g{gh, gw, gd, n_in, cy * cy, cx * cx, cz * cz};
  const int slab = g.slab();
  const size_t n = static_cast<size_t>(slab) * n_in;
  const size_t nn = static_cast<size_t>(n_in) * n_in;
  const size_t P = static_cast<size_t>(h) * w;

  std::vector<PixelStamp> stamps;
  build_stamps(edge_ds, h, w, gh, gw, gd, stamps);

  // input with ones channel appended
  std::vector<double> in1(P * n_in);
  for (size_t p = 0; p < P; ++p) {
    for (int i = 0; i < in_ch; ++i) in1[p * n_in + i] = input_ds[p * in_ch + i];
    in1[p * n_in + in_ch] = 1.0;
  }

  // the operator is the same for every output channel: build and factor once
  std::vector<double> blocks(static_cast<size_t>(slab) * kStencil * nn);
  build_data_stencil(stamps, in1.data(), weight_ds, g, blocks.data());
  std::vector<double> factors(static_cast<size_t>(slab) * nn);
  factor_blocks(g, blocks.data(), factors.data());

  // PCG for every output channel at once (one pass over the operator per
  // iteration), each channel with its own step sizes, stopping on its own
  const int m = n_out;
  const size_t nm = n * m;
  std::vector<double> x(nm, 0.0), r(nm, 0.0), z(nm), pvec(nm), ap(nm);
  // r = b = S^T W Y
  for (size_t p = 0; p < P; ++p) {
    const PixelStamp& st = stamps[p];
    const double wp = weight_ds ? weight_ds[p] : 1.0;
    for (int c = 0; c < st.n; ++c) {
      double* rv = r.data() + static_cast<size_t>(st.corner[c]) * n_in * m;
      const double f = wp * st.weight[c];
      for (int i = 0; i < n_in; ++i)
        for (int o = 0; o < m; ++o)
          rv[i * m + o] += f * in1[p * n_in + i] * output_ds[p * n_out + o];
    }
  }
  std::vector<double> rhs_norm(m, 0.0), rz(m, 0.0), rel(m, 0.0), pap(m), rz_new(m), rr(m);
  std::vector<int> status(m), iters(m, 0);
  apply_block_inverse(slab, n_in, m, factors.data(), r.data(), z.data());
  pvec = z;
  for (size_t k = 0; k < n; ++k)
    for (int o = 0; o < m; ++o) {
      const double rk = r[k * m + o];
      rhs_norm[o] += rk * rk;
      rz[o] += rk * z[k * m + o];
    }
  int active = 0;
  for (int o = 0; o < m; ++o) {
    rhs_norm[o] = std::sqrt(rhs_norm[o]);
    rel[o] = rhs_norm[o] > 0.0 ? 1.0 : 0.0;  // b = 0: x = 0 solves it
    if (rhs_norm[o] == 0.0) rhs_norm[o] = 1.0;
    status[o] = rel[o] <= tol ? BGU_CONVERGED : BGU_MAX_ITERS;
    active += status[o] == BGU_MAX_ITERS;
  }
  for (int it = 0; active > 0 && it < max_iters; ++it) {
    normal_apply(g, blocks.data(), m, pvec.data(), ap.data());
    std::fill(pap.begin(), pap.end(), 0.0);
    for (size_t k = 0; k < n; ++k)
      for (int o = 0; o < m; ++o) pap[o] += pvec[k * m + o] * ap[k * m + o];
    std::vector<double> alpha(m, 0.0);
    for (int o = 0; o < m; ++o) {
      if (status[o] != BGU_MAX_ITERS) continue;
      if (!(pap[o] > 0)) {
        status[o] = BGU_NOT_POSITIVE;
        --active;
        continue;
      }
      alpha[o] = rz[o] / pap[o];
      ++iters[o];
    }
    std::fill(rr.begin(), rr.end(), 0.0);
    for (size_t k = 0; k < n; ++k)
      for (int o = 0; o < m; ++o) {
        const size_t q = k * m + o;
        x[q] += alpha[o] * pvec[q];
        r[q] -= alpha[o] * ap[q];
        rr[o] += r[q] * r[q];
      }
    for (int o = 0; o < m; ++o) {
      if (status[o] != BGU_MAX_ITERS || alpha[o] == 0.0) continue;
      rel[o] = std::sqrt(rr[o]) / rhs_norm[o];
      if (rel[o] <= tol) {
        status[o] = BGU_CONVERGED;
        --active;
      }
    }
    if (active == 0) break;
    apply_block_inverse(slab, n_in, m, factors.data(), r.data(), z.data());
    std::fill(rz_new.begin(), rz_new.end(), 0.0);
    for (size_t k = 0; k < n; ++k)
      for (int o = 0; o < m; ++o) rz_new[o] += r[k * m + o] * z[k * m + o];
    for (size_t k = 0; k < n; ++k)
      for (int o = 0; o < m; ++o) {
        if (status[o] != BGU_MAX_ITERS) continue;
        const size_t q = k * m + o;
        pvec[q] = z[q] + (rz_new[o] / rz[o]) * pvec[q];
      }
    for (int o = 0; o < m; ++o)
      if (status[o] == BGU_MAX_ITERS) rz[o] = rz_new[o];
  }

  int most_iters = 0;
  for (int o = 0; o < m; ++o) {
    if (iters_out) iters_out[o] = iters[o];
    if (residual_out) residual_out[o] = rel[o];
    if (status_out) status_out[o] = status[o];
    if (iters[o] > most_iters) most_iters = iters[o];
  }
  // gamma[y, x, z, o, i] from the unknowns of vertex (z*gw + x)*gh + y
  for (int zz = 0; zz < gd; ++zz)
    for (int xx = 0; xx < gw; ++xx)
      for (int yy = 0; yy < gh; ++yy) {
        const double* xv = x.data() + g.vertex(zz, xx, yy) * n_in * m;
        const size_t dst = ((static_cast<size_t>(yy) * gw + xx) * gd + zz) * n_out * n_in;
        for (int o = 0; o < m; ++o)
          for (int i = 0; i < n_in; ++i) gamma_out[dst + o * n_in + i] = xv[i * m + o];
      }
  return most_iters;
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
