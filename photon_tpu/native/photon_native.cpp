// photon_native: C++ host-runtime kernels for photon_tpu.
//
// Replacement for the reference's native host-side data path:
// the teem-based NRRD volume loader and the refractive-index gradient
// precompute that the CUDA host runtime performs before kernel launch
// (ref: cuda_codes/trace_rays_through_density_gradients.h loadNRRD
// :1663-1817, setData :1820-2002), plus the cubic B-spline prefilter the
// reference runs as CUDA kernels (CubicInterpolationCUDA).  Here these
// are host-side data-preparation stages feeding device arrays, so they
// live in portable C++ (exposed through ctypes; Python fallbacks exist in
// photon_tpu.volume / photon_tpu.ops.interp).
//
// Build:  make -C photon_tpu/native  (or photon_tpu.native.build())

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// NRRD header probe: returns sizes/spacings/origin so Python can mmap the
// payload without parsing.  Raw little-endian float32 encoding only (the
// layout written by photon_tpu.utils.nrrd_io and the reference sample
// data); other encodings fall back to the Python reader.
// Returns 0 on success.
// ---------------------------------------------------------------------------
int nrrd_probe(const char* path, int64_t sizes[3], double spacings[3],
               double origin[3], int64_t* payload_offset) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return 1;
  std::string line;
  if (!std::getline(f, line) || line.rfind("NRRD", 0) != 0) return 2;

  bool raw = false, floats = false;
  sizes[0] = sizes[1] = sizes[2] = 0;
  spacings[0] = spacings[1] = spacings[2] = 1.0;
  origin[0] = origin[1] = origin[2] = 0.0;

  while (std::getline(f, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    if (line.empty()) break;  // header terminator
    if (line[0] == '#') continue;
    auto colon = line.find(':');
    if (colon == std::string::npos) continue;
    std::string key = line.substr(0, colon);
    std::string value = line.substr(colon + 1);
    // strip leading "= " and spaces
    size_t start = value.find_first_not_of("= ");
    value = (start == std::string::npos) ? "" : value.substr(start);

    if (key == "type") {
      floats = (value == "float" || value == "f4" || value == "float32");
    } else if (key == "encoding") {
      raw = (value == "raw");
    } else if (key == "sizes") {
      std::istringstream ss(value);
      ss >> sizes[0] >> sizes[1] >> sizes[2];
    } else if (key == "spacings") {
      std::istringstream ss(value);
      ss >> spacings[0] >> spacings[1] >> spacings[2];
    } else if (key == "space origin") {
      for (auto& c : value)
        if (c == '(' || c == ')' || c == ',') c = ' ';
      std::istringstream ss(value);
      ss >> origin[0] >> origin[1] >> origin[2];
    }
  }
  if (!raw || !floats || sizes[0] <= 0) return 3;
  *payload_offset = static_cast<int64_t>(f.tellg());
  return 0;
}

// ---------------------------------------------------------------------------
// Finite-difference gradient precompute.
//
// Input:  n-1 values, shape (W, H, D) indexed [x][y][z] (x slowest here:
//         in C order data[(x*H + y)*D + z]).
// Output: packed float4-per-voxel (dn/dx, dn/dy, dn/dz, n-1), laid out
//         (D, H, W, 4) indexed [z][y][x] — the marcher's layout.
// Stencils: central in the interior, 2nd-order one-sided at faces
// (ref: setData:1856-1995).
// ---------------------------------------------------------------------------
void gradient_field(const float* data, int64_t W, int64_t H, int64_t D,
                    double dx, double dy, double dz, float* out) {
  auto at = [&](int64_t x, int64_t y, int64_t z) -> double {
    return static_cast<double>(data[(x * H + y) * D + z]);
  };
  auto deriv = [](double s_m1, double s_p1, double h) {
    return (s_p1 - s_m1) / (2.0 * h);
  };
  auto one_sided = [](double s0, double s1, double s2, double h) {
    return (-1.5 * s0 + 2.0 * s1 - 0.5 * s2) / h;
  };

  for (int64_t z = 0; z < D; ++z) {
    for (int64_t y = 0; y < H; ++y) {
      for (int64_t x = 0; x < W; ++x) {
        double gx, gy, gz;
        if (x == 0)
          gx = one_sided(at(0, y, z), at(1, y, z), at(2, y, z), dx);
        else if (x == W - 1)
          gx = -one_sided(at(W - 1, y, z), at(W - 2, y, z), at(W - 3, y, z),
                          dx);
        else
          gx = deriv(at(x - 1, y, z), at(x + 1, y, z), dx);

        if (y == 0)
          gy = one_sided(at(x, 0, z), at(x, 1, z), at(x, 2, z), dy);
        else if (y == H - 1)
          gy = -one_sided(at(x, H - 1, z), at(x, H - 2, z), at(x, H - 3, z),
                          dy);
        else
          gy = deriv(at(x, y - 1, z), at(x, y + 1, z), dy);

        if (z == 0)
          gz = one_sided(at(x, y, 0), at(x, y, 1), at(x, y, 2), dz);
        else if (z == D - 1)
          gz = -one_sided(at(x, y, D - 1), at(x, y, D - 2), at(x, y, D - 3),
                          dz);
        else
          gz = deriv(at(x, y, z - 1), at(x, y, z + 1), dz);

        float* o = out + ((z * H + y) * W + x) * 4;
        o[0] = static_cast<float>(gx);
        o[1] = static_cast<float>(gy);
        o[2] = static_cast<float>(gz);
        o[3] = data[(x * H + y) * D + z];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Cubic B-spline prefilter (separable recursive filter), in place over a
// (D, H, W, C) float32 array.  Same math as photon_tpu.ops.interp
// .bspline_prefilter and the reference's CubicBSplinePrefilter3D.
// ---------------------------------------------------------------------------
static void filter_line(double* line, int64_t n) {
  const double z = std::sqrt(3.0) - 2.0;
  const double lam = (1.0 - z) * (1.0 - 1.0 / z);
  if (n < 2) {
    line[0] *= lam * z / (z - 1.0);  // degenerate; matches gain-normalized id
    return;
  }
  // causal init: truncated geometric series
  int64_t horizon = n;
  double zk = 1.0, c0 = 0.0;
  for (int64_t k = 0; k < horizon && std::fabs(zk) > 1e-10; ++k) {
    c0 += zk * line[k];
    zk *= z;
  }
  line[0] = lam * c0;
  for (int64_t i = 1; i < n; ++i) line[i] = lam * line[i] + z * line[i - 1];
  line[n - 1] = (z / (z * z - 1.0)) * (z * line[n - 2] + line[n - 1]);
  for (int64_t i = n - 2; i >= 0; --i)
    line[i] = z * (line[i + 1] - line[i]);
}

void bspline_prefilter_3d(float* field, int64_t D, int64_t H, int64_t W,
                          int64_t C) {
  std::vector<double> line;
  // along W (stride C)
  line.resize(W);
  for (int64_t z = 0; z < D; ++z)
    for (int64_t y = 0; y < H; ++y)
      for (int64_t c = 0; c < C; ++c) {
        float* base = field + ((z * H + y) * W) * C + c;
        for (int64_t x = 0; x < W; ++x) line[x] = base[x * C];
        filter_line(line.data(), W);
        for (int64_t x = 0; x < W; ++x)
          base[x * C] = static_cast<float>(line[x]);
      }
  // along H (stride W*C)
  line.resize(H);
  for (int64_t z = 0; z < D; ++z)
    for (int64_t x = 0; x < W; ++x)
      for (int64_t c = 0; c < C; ++c) {
        float* base = field + (z * H * W + x) * C + c;
        for (int64_t y = 0; y < H; ++y) line[y] = base[y * W * C];
        filter_line(line.data(), H);
        for (int64_t y = 0; y < H; ++y)
          base[y * W * C] = static_cast<float>(line[y]);
      }
  // along D (stride H*W*C)
  line.resize(D);
  for (int64_t y = 0; y < H; ++y)
    for (int64_t x = 0; x < W; ++x)
      for (int64_t c = 0; c < C; ++c) {
        float* base = field + (y * W + x) * C + c;
        for (int64_t z = 0; z < D; ++z) line[z] = base[z * H * W * C];
        filter_line(line.data(), D);
        for (int64_t z = 0; z < D; ++z)
          base[z * H * W * C] = static_cast<float>(line[z]);
      }
}

}  // extern "C"
