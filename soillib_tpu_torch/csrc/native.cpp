// soillib_tpu_torch native runtime — C++ hot paths behind the Python I/O
// layer: the port's own copy of the JAX package's
// soillib_tpu/native/src/native.cpp, built by soillib_tpu_torch/native.py
// with g++ into soillib_tpu_torch/_build/ and loaded with ctypes.
//
// The reference implements its entire I/O layer in C++ (libtiff-backed
// codec, io/tiff.hpp; PLY triangulation writer, io/mesh.hpp; FastNoiseLite
// FBm, op/noise.hpp). Here the *formats* are implemented in Python
// (io/tiffcore.py — self-contained, no libtiff) and the byte-crunching
// inner loops live in this translation unit, exposed over a plain C ABI
// and loaded with ctypes (no pybind/nanobind in the image).
//
// Exports:
//   soil_lzw_decode       TIFF LZW (MSB-first, early-change) decompressor
//   soil_packbits_decode  TIFF PackBits decompressor
//   soil_ply_write        binary/ascii PLY emitter (vertices + tri faces)
//   soil_triangulate      NaN-skipping heightfield triangulation
//                         (io/mesh.hpp:49-118 semantics)
//   soil_fbm2             OpenSimplex2-style FBm fractal noise, threaded
//                         (op/noise.hpp:42-56 semantics)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// --------------------------------------------------------------------------
// TIFF LZW (spec variant: MSB-first codes, early code-width change).
// Mirrors io/tiffcore.py:_unpack_lzw; returns bytes written, -1 on error.
// --------------------------------------------------------------------------
long long soil_lzw_decode(const uint8_t* src, long long n,
                          uint8_t* dst, long long cap) {
  constexpr int CLEAR = 256, EOI = 257;
  // Dictionary as (prefix, suffix) pairs; entry i < 256 is the literal i.
  std::vector<int32_t> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096, 0);
  std::vector<uint8_t> stack;
  stack.reserve(4096);

  int next = 258, width = 9;
  long long out = 0;
  uint64_t bits = 0;
  int nbits = 0;
  long long pos = 0;
  int prev = -1;

  auto emit = [&](int code) -> bool {
    stack.clear();
    int c = code;
    while (c >= 256) {
      if (c >= next) return false;
      stack.push_back(suffix[c]);
      c = prefix[c];
    }
    stack.push_back(static_cast<uint8_t>(c));
    long long m = static_cast<long long>(stack.size());
    if (out + m > cap) return false;
    for (long long i = 0; i < m; ++i) dst[out + i] = stack[m - 1 - i];
    out += m;
    return true;
  };
  auto first_of = [&](int code) -> uint8_t {
    int c = code;
    while (c >= 256) c = prefix[c];
    return static_cast<uint8_t>(c);
  };

  while (true) {
    while (nbits < width && pos < n) {
      bits = (bits << 8) | src[pos++];
      nbits += 8;
    }
    if (nbits < width) break;
    int code = static_cast<int>((bits >> (nbits - width)) &
                                ((1u << width) - 1));
    nbits -= width;

    if (code == EOI) break;
    if (code == CLEAR) {
      next = 258;
      width = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (!emit(code)) return -1;
      prev = code;
    } else {
      if (code < next) {
        if (!emit(code)) return -1;
        if (next < 4096) {
          prefix[next] = prev;
          suffix[next] = first_of(code);
          ++next;
        }
      } else if (code == next) {
        if (next < 4096) {
          prefix[next] = prev;
          suffix[next] = first_of(prev);
          ++next;
        }
        if (!emit(code)) return -1;
      } else {
        return -1;
      }
      prev = code;
    }
    // Early change: width grows when the NEXT code might not fit.
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  return out;
}

// --------------------------------------------------------------------------
// TIFF PackBits. Returns bytes written, -1 on error.
// --------------------------------------------------------------------------
long long soil_packbits_decode(const uint8_t* src, long long n,
                               uint8_t* dst, long long expected) {
  long long i = 0, out = 0;
  while (i < n && out < expected) {
    int8_t h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      long long m = h + 1;
      if (i + m > n || out + m > expected) return -1;
      std::memcpy(dst + out, src + i, m);
      i += m;
      out += m;
    } else if (h != -128) {
      long long m = 1 - h;
      if (i >= n || out + m > expected) return -1;
      std::memset(dst + out, src[i++], m);
      out += m;
    }
  }
  return out;
}

// --------------------------------------------------------------------------
// Heightfield triangulation (io/mesh.hpp:49-118): NaN cells are skipped,
// valid cells become vertices (x*sx, y*sy, hnorm*sz), quads with 4 valid
// corners emit 2 triangles. Two-phase: count then fill.
//   vertices: caller buffer (3 * n_valid floats)
//   faces:    caller buffer (3 * 2 * n_quads int32)
// soil_tri_count computes exact sizes first.
// --------------------------------------------------------------------------
void soil_tri_count(const float* h, int64_t W, int64_t H,
                    int64_t* n_verts, int64_t* n_faces) {
  int64_t nv = 0;
  for (int64_t i = 0; i < W * H; ++i) nv += !std::isnan(h[i]);
  int64_t nf = 0;
  for (int64_t x = 0; x + 1 < W; ++x)
    for (int64_t y = 0; y + 1 < H; ++y) {
      bool ok = !std::isnan(h[x * H + y]) && !std::isnan(h[(x + 1) * H + y]) &&
                !std::isnan(h[x * H + y + 1]) &&
                !std::isnan(h[(x + 1) * H + y + 1]);
      nf += ok ? 2 : 0;
    }
  *n_verts = nv;
  *n_faces = nf;
}

void soil_triangulate(const float* h, int64_t W, int64_t H,
                      float sx, float sy, float sz,
                      float* vertices, int32_t* faces) {
  // min/max normalize (NaN-aware)
  float hmin = INFINITY, hmax = -INFINITY;
  for (int64_t i = 0; i < W * H; ++i) {
    float v = h[i];
    if (!std::isnan(v)) {
      hmin = v < hmin ? v : hmin;
      hmax = v > hmax ? v : hmax;
    }
  }
  float scale = hmax > hmin ? 1.0f / (hmax - hmin) : 0.0f;

  std::vector<int32_t> remap(W * H, -1);
  int64_t nv = 0;
  for (int64_t x = 0; x < W; ++x)
    for (int64_t y = 0; y < H; ++y) {
      float v = h[x * H + y];
      if (std::isnan(v)) continue;
      remap[x * H + y] = static_cast<int32_t>(nv);
      vertices[3 * nv + 0] = x * sx;
      vertices[3 * nv + 1] = y * sy;
      vertices[3 * nv + 2] = (v - hmin) * scale * sz;
      ++nv;
    }
  int64_t nf = 0;
  for (int64_t x = 0; x + 1 < W; ++x)
    for (int64_t y = 0; y + 1 < H; ++y) {
      int32_t i00 = remap[x * H + y], i10 = remap[(x + 1) * H + y];
      int32_t i01 = remap[x * H + y + 1], i11 = remap[(x + 1) * H + y + 1];
      if (i00 < 0 || i10 < 0 || i01 < 0 || i11 < 0) continue;
      faces[3 * nf + 0] = i00; faces[3 * nf + 1] = i10; faces[3 * nf + 2] = i11;
      ++nf;
      faces[3 * nf + 0] = i00; faces[3 * nf + 1] = i11; faces[3 * nf + 2] = i01;
      ++nf;
    }
}

// --------------------------------------------------------------------------
// PLY writer (binary little-endian or ascii). Returns 0 on success.
// --------------------------------------------------------------------------
int soil_ply_write(const char* path, const float* vertices, int64_t nv,
                   const int32_t* faces, int64_t nf, int binary) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "ply\nformat %s 1.0\nelement vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n"
               "element face %lld\n"
               "property list uchar int vertex_indices\nend_header\n",
               binary ? "binary_little_endian" : "ascii",
               static_cast<long long>(nv), static_cast<long long>(nf));
  if (binary) {
    std::fwrite(vertices, sizeof(float), 3 * nv, f);
    // pack [u8 count=3][3 x i32] per face
    std::vector<uint8_t> row(1 + 12);
    for (int64_t i = 0; i < nf; ++i) {
      row[0] = 3;
      std::memcpy(row.data() + 1, faces + 3 * i, 12);
      std::fwrite(row.data(), 1, 13, f);
    }
  } else {
    for (int64_t i = 0; i < nv; ++i)
      std::fprintf(f, "%g %g %g\n", vertices[3 * i], vertices[3 * i + 1],
                   vertices[3 * i + 2]);
    for (int64_t i = 0; i < nf; ++i)
      std::fprintf(f, "3 %d %d %d\n", faces[3 * i], faces[3 * i + 1],
                   faces[3 * i + 2]);
  }
  std::fclose(f);
  return 0;
}

// --------------------------------------------------------------------------
// 3-D simplex gradient noise + FBm, matching ops/noise.py (same hash mix
// and gradient table) so the CPU path is numerically interchangeable with
// the torch path. Threaded over rows.
// --------------------------------------------------------------------------
static inline uint32_t hash3(int32_t i, int32_t j, int32_t k, uint32_t seed) {
  uint32_t h = static_cast<uint32_t>(i) * 0x8DA6B343u +
               static_cast<uint32_t>(j) * 0xD8163841u +
               static_cast<uint32_t>(k) * 0xCB1AB31Fu + seed * 0x9E3779B9u;
  h ^= h >> 15; h *= 0x85EBCA6Bu;
  h ^= h >> 13; h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

static const float GRAD3[12][3] = {
    {1, 1, 0},  {-1, 1, 0},  {1, -1, 0}, {-1, -1, 0},
    {1, 0, 1},  {-1, 0, 1},  {1, 0, -1}, {-1, 0, -1},
    {0, 1, 1},  {0, -1, 1},  {0, 1, -1}, {0, -1, -1}};

static inline float grad_dot(int32_t i, int32_t j, int32_t k, uint32_t seed,
                             float dx, float dy, float dz) {
  const float* g = GRAD3[hash3(i, j, k, seed) % 12u];
  return g[0] * dx + g[1] * dy + g[2] * dz;
}

static float simplex3(float x, float y, float z, uint32_t seed) {
  const float F3 = 1.0f / 3.0f, G3 = 1.0f / 6.0f;
  float s = (x + y + z) * F3;
  int32_t i = static_cast<int32_t>(std::floor(x + s));
  int32_t j = static_cast<int32_t>(std::floor(y + s));
  int32_t k = static_cast<int32_t>(std::floor(z + s));
  float t = (i + j + k) * G3;
  float x0 = x - (i - t), y0 = y - (j - t), z0 = z - (k - t);

  int i1, j1, k1, i2, j2, k2;
  if (x0 >= y0) {
    if (y0 >= z0)      { i1=1; j1=0; k1=0; i2=1; j2=1; k2=0; }
    else if (x0 >= z0) { i1=1; j1=0; k1=0; i2=1; j2=0; k2=1; }
    else               { i1=0; j1=0; k1=1; i2=1; j2=0; k2=1; }
  } else {
    if (y0 < z0)       { i1=0; j1=0; k1=1; i2=0; j2=1; k2=1; }
    else if (x0 < z0)  { i1=0; j1=1; k1=0; i2=0; j2=1; k2=1; }
    else               { i1=0; j1=1; k1=0; i2=1; j2=1; k2=0; }
  }
  float x1 = x0 - i1 + G3, y1 = y0 - j1 + G3, z1 = z0 - k1 + G3;
  float x2 = x0 - i2 + 2*G3, y2 = y0 - j2 + 2*G3, z2 = z0 - k2 + 2*G3;
  float x3 = x0 - 1 + 3*G3, y3 = y0 - 1 + 3*G3, z3 = z0 - 1 + 3*G3;

  float n = 0.0f;
  auto corner = [&](float dx, float dy, float dz, int ci, int cj, int ck) {
    float tt = 0.6f - dx*dx - dy*dy - dz*dz;
    if (tt < 0) return 0.0f;
    tt *= tt;
    return tt * tt * grad_dot(ci, cj, ck, seed, dx, dy, dz);
  };
  n += corner(x0, y0, z0, i, j, k);
  n += corner(x1, y1, z1, i + i1, j + j1, k + k1);
  n += corner(x2, y2, z2, i + i2, j + j2, k + k2);
  n += corner(x3, y3, z3, i + 1, j + 1, k + 1);
  return 32.0f * n;
}

void soil_fbm2(float* out, int64_t W, int64_t H, float inv_ext_x,
               float inv_ext_y, float frequency, int octaves, float gain,
               float lacunarity, float z) {
  float bounding = 0.0f, amp = 1.0f;
  for (int o = 0; o < octaves; ++o) { bounding += amp; amp *= gain; }
  float inv_bounding = 1.0f / bounding;

  int nthreads = std::max(1u, std::thread::hardware_concurrency());
  std::atomic<int64_t> next_row(0);
  auto work = [&]() {
    int64_t x;
    while ((x = next_row.fetch_add(1)) < W) {
      for (int64_t y = 0; y < H; ++y) {
        float px = static_cast<float>(x) * inv_ext_x;
        float py = static_cast<float>(y) * inv_ext_y;
        float total = 0.0f, a = 1.0f, f = frequency;
        for (int o = 0; o < octaves; ++o) {
          total += a * simplex3(px * f, py * f, z * f,
                                static_cast<uint32_t>(o * 1013 + 7));
          a *= gain;
          f *= lacunarity;
        }
        out[x * H + y] = total * inv_bounding;
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
}

}  // extern "C"
