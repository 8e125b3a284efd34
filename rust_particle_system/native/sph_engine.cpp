// Native host-side SPH engine — the C++ analog of the reference's Rust host tier.
//
// The reference implements its host runtime in Rust (buffer management
// `src/particle_buffers.rs`, dispatch orchestration `src/particle_compute.rs`); this
// framework's host tier is Python/JAX, and this C++ engine supplies the two pieces
// where native code genuinely earns its keep:
//
//   1. a fast, deterministic CPU oracle of the bulk-synchronous SPH step (same spec as
//      ops/reference_step.py / ops/grid_step.py) with an O(n·k) uniform grid — used by
//      the test pyramid to validate device trajectories at particle counts where the
//      NumPy loop oracle is unusable;
//   2. zero-copy binary state IO (header + CRC32) for checkpoint interchange.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency by design).
//
// Build: cc -O2 -shared -fPIC -o libsph_engine.so sph_engine.cpp  (see build.sh)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

struct SphParams {
  float smoothing_radius;
  float max_energy;
  float damping_factor;
  float dt;
  float gravity;
  float target_density;
  float pressure_multiplier;
  float viscosity_strength;
  float near_density_multiplier;
  float x_min, x_max, y_min, y_max;
  float density_norm, near_density_norm, viscosity_norm;
};

// One bulk-synchronous frame over n particles (same phase order as
// ops/reference_step.py; see that module's docstring for the spec derivation from
// assets/compute_shader.wgsl). pos/vel are [n*2] interleaved xy; color is [n*4].
// Returns 0 on success.
int sph_step(const SphParams* p, int64_t n, float* pos, float* vel, float* color) {
  const float h = p->smoothing_radius;
  const float h2 = h * h;
  const float dt = p->dt;

  // 1. gravity + predicted positions
  std::vector<float> pred(2 * n);
  for (int64_t i = 0; i < n; ++i) {
    vel[2 * i + 1] -= p->gravity * dt;
    pred[2 * i] = pos[2 * i] + vel[2 * i] * dt;
    pred[2 * i + 1] = pos[2 * i + 1] + vel[2 * i + 1] * dt;
  }

  // 2. uniform grid over predicted positions (dense keys, counting sort)
  const int gw = (int)std::floor((p->x_max - p->x_min) / h) + 1;
  const int gh = (int)std::floor((p->y_max - p->y_min) / h) + 1;
  const int64_t ncells = (int64_t)gw * gh;
  auto cell_of = [&](float x, float y) -> int64_t {
    int cx = (int)std::floor((x - p->x_min) / h);
    int cy = (int)std::floor((y - p->y_min) / h);
    cx = std::min(std::max(cx, 0), gw - 1);
    cy = std::min(std::max(cy, 0), gh - 1);
    return (int64_t)cy * gw + cx;
  };
  std::vector<int64_t> key(n);
  std::vector<int64_t> start(ncells + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    key[i] = cell_of(pred[2 * i], pred[2 * i + 1]);
    start[key[i] + 1]++;
  }
  for (int64_t c = 0; c < ncells; ++c) start[c + 1] += start[c];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cursor[key[i]]++] = i;  // stable
  }

  auto for_neighbors = [&](int64_t i, auto&& fn) {
    const float xi = pred[2 * i], yi = pred[2 * i + 1];
    int cx = (int)std::floor((xi - p->x_min) / h);
    int cy = (int)std::floor((yi - p->y_min) / h);
    cx = std::min(std::max(cx, 0), gw - 1);
    cy = std::min(std::max(cy, 0), gh - 1);
    for (int dy = -1; dy <= 1; ++dy) {
      int ny = cy + dy;
      if (ny < 0 || ny >= gh) continue;
      for (int dx = -1; dx <= 1; ++dx) {
        int nx = cx + dx;
        if (nx < 0 || nx >= gw) continue;
        int64_t c = (int64_t)ny * gw + nx;
        for (int64_t s = start[c]; s < start[c + 1]; ++s) {
          int64_t j = order[s];
          float ddx = pred[2 * j] - xi, ddy = pred[2 * j + 1] - yi;
          float d2 = ddx * ddx + ddy * ddy;
          if (d2 <= h2) fn(j, ddx, ddy, std::sqrt(d2));
        }
      }
    }
  };

  // 3. density (self included: compute_shader.wgsl:207-254).
  // Double-precision accumulation: this engine is a test ORACLE, so it carries more
  // precision than the f32 device paths it validates (near-cancelling pressure sums
  // are tolerance-fragile in f32 when neighbour iteration order differs).
  std::vector<float> rho(n, 0.0f), rhon(n, 0.0f);
  for (int64_t i = 0; i < n; ++i) {
    double r = 0.0, rn = 0.0;
    for_neighbors(i, [&](int64_t, float, float, float d) {
      if (d < h) {
        double v = (double)h - (double)d;
        r += (double)p->density_norm * v * v;
        rn += (double)p->near_density_norm * v * v * v;
      }
    });
    rho[i] = (float)r;
    rhon[i] = (float)rn;
  }

  // 4. forces in one barrier (spec v2, see ops/reference_step.py): pressure force
  // (self excluded; reference's ρ_j·ρnear_j quirk kept) + viscosity over the
  // PRE-pressure (post-gravity) velocities.
  std::vector<float> new_vel(vel, vel + 2 * n);
  for (int64_t i = 0; i < n; ++i) {
    double fx = 0.0, fy = 0.0;
    const double pi_ = ((double)rho[i] - p->target_density) * p->pressure_multiplier;
    const double npi = (double)rhon[i] * p->near_density_multiplier;
    const double inv_rho_i2 = 1.0 / ((double)rho[i] * rho[i]);
    double vfx = 0.0, vfy = 0.0;
    for_neighbors(i, [&](int64_t j, float ddx, float ddy, float d) {
      if (j == i || d >= h) return;
      double dirx, diry;
      if (d > 1e-4f) {
        dirx = (double)ddx / d;
        diry = (double)ddy / d;
      } else {
        dirx = 0.0;
        diry = 1.0;
      }
      double pj = ((double)rho[j] - p->target_density) * p->pressure_multiplier;
      double npj = (double)rhon[j] * p->near_density_multiplier;
      double pressure_term = pi_ * inv_rho_i2 + pj / ((double)rho[j] * rho[j]);
      double near_term = npi * inv_rho_i2 + npj / ((double)rho[j] * rhon[j]);
      double v = (double)h - d;
      double dw = -2.0 * p->density_norm * v;
      double dwn = -3.0 * p->near_density_norm * v * v;
      double mag = pressure_term * dw + near_term * dwn;
      fx += dirx * mag;
      fy += diry * mag;

      double u = (double)h * h - (double)d * d;
      double w = (double)p->viscosity_norm * u * u * u;
      vfx += ((double)vel[2 * j] - vel[2 * i]) * w;
      vfy += ((double)vel[2 * j + 1] - vel[2 * i + 1]) * w;
    });
    new_vel[2 * i] =
        (float)(vel[2 * i] + fx * dt + vfx * p->viscosity_strength * dt);
    new_vel[2 * i + 1] =
        (float)(vel[2 * i + 1] + fy * dt + vfy * p->viscosity_strength * dt);
  }
  std::memcpy(vel, new_vel.data(), sizeof(float) * 2 * n);

  // 6. integrate + bounce + colour (compute_shader.wgsl:69-118)
  for (int64_t i = 0; i < n; ++i) {
    float x = pos[2 * i] + vel[2 * i] * dt;
    float y = pos[2 * i + 1] + vel[2 * i + 1] * dt;
    float vx = vel[2 * i], vy = vel[2 * i + 1];
    if (x <= p->x_min) {
      x = p->x_min;
      vx = std::fabs(vx) * p->damping_factor;
    } else if (x >= p->x_max) {
      x = p->x_max;
      vx = -std::fabs(vx) * p->damping_factor;
    }
    if (y <= p->y_min) {
      y = p->y_min;
      vy = std::fabs(vy) * p->damping_factor;
    } else if (y >= p->y_max) {
      y = p->y_max;
      vy = -std::fabs(vy) * p->damping_factor;
    }
    pos[2 * i] = x;
    pos[2 * i + 1] = y;
    vel[2 * i] = vx;
    vel[2 * i + 1] = vy;

    float energy = 0.5f * (vx * vx + vy * vy);
    float t = energy / p->max_energy;
    t = std::min(std::max(t, 0.0f), 1.0f);
    float r, g, b;
    if (t < 0.5f) {
      float s = t * 2.0f;
      r = 0.0f;
      g = s;
      b = 1.0f - s;
    } else {
      float s = (t - 0.5f) * 2.0f;
      r = s;
      g = 1.0f - s;
      b = 0.0f;
    }
    color[4 * i] = r;
    color[4 * i + 1] = g;
    color[4 * i + 2] = b;
    color[4 * i + 3] = 1.0f;
  }
  return 0;
}

// ---------------------------------------------------------------------------------
// Binary state IO: [magic u32][version u32][n i64][pos][vel][color][crc32 u32]
// ---------------------------------------------------------------------------------

static uint32_t crc32_update(uint32_t crc, const uint8_t* data, size_t len) {
  crc = ~crc;
  for (size_t i = 0; i < len; ++i) {
    crc ^= data[i];
    for (int k = 0; k < 8; ++k) crc = (crc >> 1) ^ (0xEDB88320u & (0u - (crc & 1u)));
  }
  return ~crc;
}

static const uint32_t kMagic = 0x53504831;  // "SPH1"

int state_save(const char* path, int64_t n, const float* pos, const float* vel,
               const float* color) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t version = 1;
  uint32_t crc = 0;
  crc = crc32_update(crc, (const uint8_t*)pos, sizeof(float) * 2 * n);
  crc = crc32_update(crc, (const uint8_t*)vel, sizeof(float) * 2 * n);
  crc = crc32_update(crc, (const uint8_t*)color, sizeof(float) * 4 * n);
  bool ok = std::fwrite(&kMagic, 4, 1, f) == 1 && std::fwrite(&version, 4, 1, f) == 1 &&
            std::fwrite(&n, 8, 1, f) == 1 &&
            std::fwrite(pos, sizeof(float) * 2, n, f) == (size_t)n &&
            std::fwrite(vel, sizeof(float) * 2, n, f) == (size_t)n &&
            std::fwrite(color, sizeof(float) * 4, n, f) == (size_t)n &&
            std::fwrite(&crc, 4, 1, f) == 1;
  std::fclose(f);
  return ok ? 0 : -2;
}

// Returns n on success, -1 open error, -2 format error, -3 CRC mismatch,
// -4 capacity too small. Pass capacity=0 to query n without reading.
int64_t state_load(const char* path, int64_t capacity, float* pos, float* vel,
                   float* color) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint32_t magic = 0, version = 0;
  int64_t n = 0;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != kMagic ||
      std::fread(&version, 4, 1, f) != 1 || version != 1 ||
      std::fread(&n, 8, 1, f) != 1 || n < 0) {
    std::fclose(f);
    return -2;
  }
  if (capacity == 0) {
    std::fclose(f);
    return n;
  }
  if (capacity < n) {
    std::fclose(f);
    return -4;
  }
  bool ok = std::fread(pos, sizeof(float) * 2, n, f) == (size_t)n &&
            std::fread(vel, sizeof(float) * 2, n, f) == (size_t)n &&
            std::fread(color, sizeof(float) * 4, n, f) == (size_t)n;
  uint32_t crc_file = 0;
  ok = ok && std::fread(&crc_file, 4, 1, f) == 1;
  std::fclose(f);
  if (!ok) return -2;
  uint32_t crc = 0;
  crc = crc32_update(crc, (const uint8_t*)pos, sizeof(float) * 2 * n);
  crc = crc32_update(crc, (const uint8_t*)vel, sizeof(float) * 2 * n);
  crc = crc32_update(crc, (const uint8_t*)color, sizeof(float) * 4 * n);
  if (crc != crc_file) return -3;
  return n;
}

}  // extern "C"
