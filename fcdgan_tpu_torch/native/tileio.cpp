// Native tile I/O: threaded raster window reads + batch canvas assembly.
//
// The host data path of the port (the reference reads through GDAL's native
// core, data_utils.py:104-105). A C API, bound with ctypes in
// fcdgan_tpu_torch/native/__init__.py:
//
//   * TIFF reader (classic + BigTIFF, either byte order): strips/tiles,
//     uncompressed/deflate/LZW/PackBits (with the horizontal predictor),
//     chunky + planar, u8/i8/u16/i16/u32/i32/f32/f64 samples
//   * ENVI reader: raw BSQ/BIL/BIP cubes described by a .hdr
//   * tio_assemble_batch: for a batch of tile indices, compute the
//     overlap-padded read windows (the arithmetic of data/tile_grid.py), read
//     both temporal images, apply per-band (x-mean)/std normalization, and
//     scatter into fixed zero-padded float32 HWC canvases, fanned out over a
//     thread pool with no Python/GIL involvement
//   * tio_assemble_batch_raw: the same canvases in the rasters' stored type,
//     unnormalized (normalized on the GPU by data/pipeline.DeviceNormalizer)
//   * tio_read_files_f32: whole slice images (the WHU slice sets)
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -std=c++17 -shared -fPIC tileio.cpp -o libtileio.so -lz -pthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <atomic>
#include <algorithm>
#include <fstream>
#include <sstream>
#include <cmath>

#include <zlib.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

// memory-mapped read-only file: arbitrarily large scenes without RAM cost
struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open_file(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size <= 0) { ::close(fd); fd = -1; return false; }
    size = (size_t)st.st_size;
    void* p = ::mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) { ::close(fd); fd = -1; return false; }
    data = (const uint8_t*)p;
    return true;
  }

  ~MappedFile() {
    if (data) ::munmap((void*)data, size);
    if (fd >= 0) ::close(fd);
  }
};

// ---------------------------------------------------------------------------
// raster abstraction
// ---------------------------------------------------------------------------

struct Raster {
  int64_t xsize = 0, ysize = 0, nband = 0;
  virtual ~Raster() = default;
  // read window into float32 HWC buffer (h*w*nband)
  virtual bool read_window(int64_t x, int64_t y, int64_t w, int64_t h,
                           float* out) = 0;
  // native sample dtype as a DType enum value (default F32 = 6); lets the
  // host ship raw integral tiles and normalize on device (device_normalize)
  virtual int dtype_code() const { return 6; }
};

// -- dtype decode helpers ----------------------------------------------------

enum class DType { U8, I8, U16, I16, U32, I32, F32, F64 };

inline int64_t dtype_size(DType t) {
  switch (t) {
    case DType::U8: case DType::I8: return 1;
    case DType::U16: case DType::I16: return 2;
    case DType::U32: case DType::I32: case DType::F32: return 4;
    case DType::F64: return 8;
  }
  return 0;
}

inline float decode_at(const uint8_t* p, DType t, bool big_endian) {
  uint8_t buf[8];
  int64_t n = dtype_size(t);
  if (big_endian) {
    for (int64_t i = 0; i < n; ++i) buf[i] = p[n - 1 - i];
    p = buf;
  }
  switch (t) {
    case DType::U8:  return (float)*p;
    case DType::I8:  return (float)*(const int8_t*)p;
    case DType::U16: { uint16_t v; memcpy(&v, p, 2); return (float)v; }
    case DType::I16: { int16_t v; memcpy(&v, p, 2); return (float)v; }
    case DType::U32: { uint32_t v; memcpy(&v, p, 4); return (float)v; }
    case DType::I32: { int32_t v; memcpy(&v, p, 4); return (float)v; }
    case DType::F32: { float v; memcpy(&v, p, 4); return v; }
    case DType::F64: { double v; memcpy(&v, p, 8); return (float)v; }
  }
  return 0.f;
}

// -- TIFF decompressors -------------------------------------------------------

// TIFF-flavor LZW (compression 5): MSB-first codes, 9..12-bit widths with the
// spec's early change (decoder bumps width when its table hits 2^w - 1).
// Table entries store (prefix index, suffix byte, length); strings are
// materialized by walking the prefix chain backwards.
bool lzw_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                size_t expected) {
  out.clear();
  out.reserve(expected);
  struct Ent { int32_t prefix; uint8_t suffix; uint32_t len; };
  std::vector<Ent> table;
  table.reserve(4096);
  auto reset = [&]() {
    table.clear();
    for (int i = 0; i < 256; ++i) table.push_back({-1, (uint8_t)i, 1});
    table.push_back({-1, 0, 0});  // 256 Clear
    table.push_back({-1, 0, 0});  // 257 EOI
  };
  std::vector<uint8_t> scratch;
  auto expand = [&](int32_t code) {
    scratch.clear();
    for (int32_t c = code; c >= 0; c = table[c].prefix) scratch.push_back(table[c].suffix);
    out.insert(out.end(), scratch.rbegin(), scratch.rend());
  };
  size_t bitpos = 0, nbits = n * 8;
  int width = 9;
  int32_t prev = -1;
  while (bitpos + width <= nbits) {
    size_t b0 = bitpos >> 3;
    uint32_t win = 0;
    for (int i = 0; i < 4; ++i) win = (win << 8) | (b0 + i < n ? src[b0 + i] : 0);
    int32_t code = (int32_t)((win >> (32 - (bitpos & 7) - width)) & ((1u << width) - 1));
    bitpos += width;
    if (code == 257) break;  // EOI
    if (code == 256) { reset(); width = 9; prev = -1; continue; }
    if (prev < 0) {
      if (table.empty() || code >= (int32_t)table.size()) return false;
      expand(code);
    } else if (code < (int32_t)table.size()) {
      expand(code);
      // first byte of `code`'s string
      int32_t c = code;
      while (table[c].prefix >= 0) c = table[c].prefix;
      table.push_back({prev, table[c].suffix, table[prev].len + 1});
    } else if (code == (int32_t)table.size()) {
      int32_t c = prev;
      while (table[c].prefix >= 0) c = table[c].prefix;
      table.push_back({prev, table[c].suffix, table[prev].len + 1});
      expand(code);
    } else {
      return false;
    }
    prev = code;
    if (table.size() == ((size_t)1 << width) - 1 && width < 12) ++width;
  }
  return true;
}

// PackBits RLE (compression 32773)
bool packbits_decode(const uint8_t* src, size_t n, std::vector<uint8_t>& out,
                     size_t expected) {
  out.clear();
  out.reserve(expected);
  size_t i = 0;
  while (i < n && out.size() < expected) {
    uint8_t ctrl = src[i++];
    if (ctrl < 128) {
      size_t cnt = (size_t)ctrl + 1;
      if (i + cnt > n) return false;
      out.insert(out.end(), src + i, src + i + cnt);
      i += cnt;
    } else if (ctrl > 128) {
      if (i >= n) return false;
      out.insert(out.end(), (size_t)257 - ctrl, src[i++]);
    }  // 128: no-op
  }
  return true;
}

// ---------------------------------------------------------------------------
// TIFF reader
// ---------------------------------------------------------------------------

struct TiffRaster : Raster {
  MappedFile mf;
  bool big_endian = false;
  DType dtype = DType::U8;
  int dtype_code() const override { return (int)dtype; }
  int compression = 1;   // 1 none, 8/32946 deflate
  int predictor = 1;
  int planar = 1;        // 1 chunky, 2 planar
  bool tiled = false;
  int64_t tile_w = 0, tile_h = 0, rows_per_strip = 0;
  std::vector<uint64_t> offsets, counts;
  std::mutex cache_mu;
  // decoded chunks, shared: a reader keeps its chunk alive while another
  // thread clears the cache or stores the same chunk decoded again
  std::map<int64_t, std::shared_ptr<const std::vector<uint8_t>>> chunk_cache;

  uint16_t rd16(size_t off) const {
    uint16_t v; memcpy(&v, mf.data + off, 2);
    if (big_endian) v = (uint16_t)((v >> 8) | (v << 8));
    return v;
  }
  uint32_t rd32(size_t off) const {
    uint32_t v; memcpy(&v, mf.data + off, 4);
    if (big_endian) v = __builtin_bswap32(v);
    return v;
  }
  uint64_t rd64(size_t off) const {
    uint64_t v; memcpy(&v, mf.data + off, 8);
    if (big_endian) v = __builtin_bswap64(v);
    return v;
  }

  struct Entry { uint16_t type; uint64_t count; size_t value_off; };

  static int64_t type_size(uint16_t t) {
    switch (t) { case 1: case 2: case 6: case 7: return 1;
                 case 3: case 8: return 2; case 4: case 9: case 11: return 4;
                 case 5: case 10: case 12: case 16: case 17: case 18: return 8; }
    return 1;
  }

  uint64_t entry_value(const Entry& e, uint64_t i) const {
    size_t off = e.value_off + i * type_size(e.type);
    switch (e.type) {
      case 1: return mf.data[off];
      case 3: return rd16(off);
      case 4: return rd32(off);
      case 16: case 17: case 18: return rd64(off);
      default: return 0;
    }
  }

  bool open(const char* path) {
    if (!mf.open_file(path) || mf.size < 16) return false;
    if (mf.data[0] == 'I' && mf.data[1] == 'I') big_endian = false;
    else if (mf.data[0] == 'M' && mf.data[1] == 'M') big_endian = true;
    else return false;
    uint16_t magic = rd16(2);
    bool big = false;       // BigTIFF: 8-byte offsets, 20-byte IFD entries
    size_t ifd;
    if (magic == 42) {
      ifd = rd32(4);
    } else if (magic == 43) {
      if (rd16(4) != 8 || rd16(6) != 0) return false;
      big = true;
      ifd = (size_t)rd64(8);
    } else {
      return false;
    }
    uint64_t n = big ? rd64(ifd) : rd16(ifd);
    size_t base = ifd + (big ? 8 : 2);
    size_t esize = big ? 20 : 12;
    int64_t inline_cap = big ? 8 : 4;
    std::map<uint16_t, Entry> tags;
    for (uint64_t i = 0; i < n; ++i) {
      size_t e = base + esize * (size_t)i;
      uint16_t tag = rd16(e), type = rd16(e + 2);
      uint64_t count = big ? rd64(e + 4) : rd32(e + 4);
      size_t voff = e + (big ? 12 : 8);
      int64_t sz = type_size(type) * (int64_t)count;
      if (sz > inline_cap) voff = big ? (size_t)rd64(voff) : rd32(voff);
      tags[tag] = Entry{type, count, voff};
    }
    auto get1 = [&](uint16_t tag, uint64_t dflt) -> uint64_t {
      auto it = tags.find(tag);
      return it == tags.end() ? dflt : entry_value(it->second, 0);
    };
    xsize = (int64_t)get1(256, 0);
    ysize = (int64_t)get1(257, 0);
    nband = (int64_t)get1(277, 1);
    uint64_t bits = get1(258, 8), sf = get1(339, 1);
    compression = (int)get1(259, 1);
    predictor = (int)get1(317, 1);
    planar = (int)get1(284, 1);
    if (compression != 1 && compression != 5 && compression != 8 &&
        compression != 32773 && compression != 32946) return false;
    if (sf == 1) dtype = bits == 8 ? DType::U8 : bits == 16 ? DType::U16 : DType::U32;
    else if (sf == 2) dtype = bits == 8 ? DType::I8 : bits == 16 ? DType::I16 : DType::I32;
    else if (sf == 3) dtype = bits == 32 ? DType::F32 : DType::F64;
    else return false;
    auto fill = [&](uint16_t tag, std::vector<uint64_t>& out) {
      auto it = tags.find(tag);
      if (it == tags.end()) return false;
      out.resize(it->second.count);
      for (uint64_t i = 0; i < it->second.count; ++i)
        out[i] = entry_value(it->second, i);
      return true;
    };
    if (tags.count(322)) {
      tiled = true;
      tile_w = (int64_t)get1(322, 0);
      tile_h = (int64_t)get1(323, 0);
      if (!fill(324, offsets) || !fill(325, counts)) return false;
    } else {
      rows_per_strip = (int64_t)get1(278, (uint64_t)ysize);
      if (!fill(273, offsets) || !fill(279, counts)) return false;
    }
    return xsize > 0 && ysize > 0;
  }

  // decode chunk -> raw sample bytes (native TIFF byte order preserved)
  std::shared_ptr<const std::vector<uint8_t>> chunk(int64_t idx, int64_t rows,
                                                    int64_t cols, int64_t spp) {
    {
      std::lock_guard<std::mutex> lk(cache_mu);
      auto it = chunk_cache.find(idx);
      if (it != chunk_cache.end()) return it->second;
    }
    auto decoded = std::make_shared<std::vector<uint8_t>>();
    std::vector<uint8_t>& raw = *decoded;
    int64_t need = rows * cols * spp * dtype_size(dtype);
    if (compression == 1) {
      raw.assign(mf.data + offsets[idx], mf.data + offsets[idx] + counts[idx]);
    } else if (compression == 5) {
      if (!lzw_decode(mf.data + offsets[idx], (size_t)counts[idx], raw, (size_t)need))
        raw.assign((size_t)need, 0);
    } else if (compression == 32773) {
      if (!packbits_decode(mf.data + offsets[idx], (size_t)counts[idx], raw, (size_t)need))
        raw.assign((size_t)need, 0);
    } else {
      raw.resize(need);
      uLongf dst = (uLongf)need;
      uncompress(raw.data(), &dst, mf.data + offsets[idx], (uLong)counts[idx]);
      raw.resize(dst);
    }
    if (predictor == 2) {
      // undo horizontal differencing: per-sample cumulative sum along each
      // row (modular integer add; TIFF 6.0 section 14)
      if (dtype == DType::U8 || dtype == DType::I8) {
        for (int64_t r = 0; r < rows; ++r) {
          uint8_t* rowp = raw.data() + r * cols * spp;
          for (int64_t c = 1; c < cols; ++c)
            for (int64_t s = 0; s < spp; ++s)
              rowp[c * spp + s] = (uint8_t)(rowp[c * spp + s] + rowp[(c - 1) * spp + s]);
        }
      } else if (dtype == DType::U16 || dtype == DType::I16) {
        for (int64_t r = 0; r < rows; ++r) {
          uint8_t* rowp = raw.data() + r * cols * spp * 2;
          for (int64_t c = 1; c < cols; ++c)
            for (int64_t s = 0; s < spp; ++s) {
              size_t cur = ((size_t)c * spp + s) * 2, pre = ((size_t)(c - 1) * spp + s) * 2;
              uint16_t a, b;
              memcpy(&a, rowp + cur, 2);
              memcpy(&b, rowp + pre, 2);
              if (big_endian) { a = (uint16_t)((a >> 8) | (a << 8)); b = (uint16_t)((b >> 8) | (b << 8)); }
              uint16_t v = (uint16_t)(a + b);
              if (big_endian) v = (uint16_t)((v >> 8) | (v << 8));
              memcpy(rowp + cur, &v, 2);
            }
        }
      } else if (dtype == DType::U32 || dtype == DType::I32) {
        for (int64_t r = 0; r < rows; ++r) {
          uint8_t* rowp = raw.data() + r * cols * spp * 4;
          for (int64_t c = 1; c < cols; ++c)
            for (int64_t s = 0; s < spp; ++s) {
              size_t cur = ((size_t)c * spp + s) * 4, pre = ((size_t)(c - 1) * spp + s) * 4;
              uint32_t a, b;
              memcpy(&a, rowp + cur, 4);
              memcpy(&b, rowp + pre, 4);
              if (big_endian) { a = __builtin_bswap32(a); b = __builtin_bswap32(b); }
              uint32_t v = a + b;
              if (big_endian) v = __builtin_bswap32(v);
              memcpy(rowp + cur, &v, 4);
            }
        }
      }
    }
    std::lock_guard<std::mutex> lk(cache_mu);
    if (chunk_cache.size() > 64) chunk_cache.clear();
    auto& slot = chunk_cache[idx];
    if (!slot) slot = std::move(decoded);
    return slot;
  }

  bool read_window(int64_t x, int64_t y, int64_t w, int64_t h, float* out) override {
    if (x < 0 || y < 0 || x + w > xsize || y + h > ysize) return false;
    int64_t bpp = dtype_size(dtype);
    int64_t spp = planar == 1 ? nband : 1;
    int64_t nplanes = planar == 1 ? 1 : nband;
    if (!tiled) {
      int64_t per_band = (ysize + rows_per_strip - 1) / rows_per_strip;
      for (int64_t p = 0; p < nplanes; ++p) {
        for (int64_t s = y / rows_per_strip; s <= (y + h - 1) / rows_per_strip; ++s) {
          int64_t row0 = s * rows_per_strip;
          int64_t rows = std::min(rows_per_strip, ysize - row0);
          const auto ch = chunk(p * per_band + s, rows, xsize, spp);
          int64_t gy0 = std::max(y, row0), gy1 = std::min(y + h, row0 + rows);
          for (int64_t gy = gy0; gy < gy1; ++gy) {
            const uint8_t* src = ch->data() + ((gy - row0) * xsize + x) * spp * bpp;
            float* dst = out + ((gy - y) * w) * nband;
            if (planar == 1) {
              for (int64_t c = 0; c < w * nband; ++c)
                dst[c] = decode_at(src + c * bpp, dtype, big_endian);
            } else {
              for (int64_t c = 0; c < w; ++c)
                dst[c * nband + p] = decode_at(src + c * bpp, dtype, big_endian);
            }
          }
        }
      }
    } else {
      int64_t across = (xsize + tile_w - 1) / tile_w;
      int64_t down = (ysize + tile_h - 1) / tile_h;
      for (int64_t p = 0; p < nplanes; ++p)
        for (int64_t ty = y / tile_h; ty <= (y + h - 1) / tile_h; ++ty)
          for (int64_t tx = x / tile_w; tx <= (x + w - 1) / tile_w; ++tx) {
            const auto ch = chunk(p * down * across + ty * across + tx,
                                  tile_h, tile_w, spp);
            int64_t gy0 = std::max(y, ty * tile_h), gy1 = std::min(y + h, (ty + 1) * tile_h);
            int64_t gx0 = std::max(x, tx * tile_w), gx1 = std::min(x + w, (tx + 1) * tile_w);
            for (int64_t gy = gy0; gy < gy1; ++gy) {
              const uint8_t* src = ch->data() +
                  (((gy - ty * tile_h) * tile_w + (gx0 - tx * tile_w))) * spp * bpp;
              float* dst = out + ((gy - y) * w + (gx0 - x)) * nband;
              if (planar == 1) {
                for (int64_t c = 0; c < (gx1 - gx0) * nband; ++c)
                  dst[c] = decode_at(src + c * bpp, dtype, big_endian);
              } else {
                for (int64_t c = 0; c < gx1 - gx0; ++c)
                  dst[c * nband + p] = decode_at(src + c * bpp, dtype, big_endian);
              }
            }
          }
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// ENVI reader
// ---------------------------------------------------------------------------

struct EnviRaster : Raster {
  MappedFile mf;
  DType dtype = DType::U8;
  int dtype_code() const override { return (int)dtype; }
  bool big_endian = false;
  int interleave = 0;  // 0 bsq, 1 bil, 2 bip
  int64_t offset = 0;

  static std::string lower(std::string s) {
    for (auto& c : s) c = (char)tolower(c);
    return s;
  }

  bool open(const char* path) {
    std::string hdr = std::string(path) + ".hdr";
    std::ifstream hf(hdr);
    if (!hf) {
      std::string base(path);
      size_t dot = base.find_last_of('.');
      if (dot != std::string::npos) hdr = base.substr(0, dot) + ".hdr";
      hf.open(hdr);
      if (!hf) return false;
    }
    std::string line;
    std::map<std::string, std::string> fields;
    while (std::getline(hf, line)) {
      size_t eq = line.find('=');
      if (eq == std::string::npos) continue;
      std::string key = lower(line.substr(0, eq));
      key.erase(key.find_last_not_of(" \t") + 1);
      key.erase(0, key.find_first_not_of(" \t"));
      std::string val = line.substr(eq + 1);
      fields[key] = val;
    }
    auto geti = [&](const char* k, int64_t dflt) -> int64_t {
      auto it = fields.find(k);
      return it == fields.end() ? dflt : atoll(it->second.c_str());
    };
    xsize = geti("samples", 0);
    ysize = geti("lines", 0);
    nband = geti("bands", 0);
    offset = geti("header offset", 0);
    big_endian = geti("byte order", 0) == 1;
    int code = (int)geti("data type", 1);
    switch (code) {
      case 1: dtype = DType::U8; break;
      case 2: dtype = DType::I16; break;
      case 3: dtype = DType::I32; break;
      case 4: dtype = DType::F32; break;
      case 5: dtype = DType::F64; break;
      case 12: dtype = DType::U16; break;
      case 13: dtype = DType::U32; break;
      default: return false;
    }
    std::string il = fields.count("interleave") ? lower(fields["interleave"]) : "bsq";
    il.erase(0, il.find_first_not_of(" \t"));
    il.erase(il.find_last_not_of(" \t\r") + 1);
    interleave = il == "bil" ? 1 : il == "bip" ? 2 : 0;
    if (!mf.open_file(path)) return false;
    return xsize > 0 && ysize > 0 && nband > 0;
  }

  bool read_window(int64_t x, int64_t y, int64_t w, int64_t h, float* out) override {
    if (x < 0 || y < 0 || x + w > xsize || y + h > ysize) return false;
    int64_t bpp = dtype_size(dtype);
    const uint8_t* base = mf.data + offset;
    for (int64_t r = 0; r < h; ++r)
      for (int64_t c = 0; c < w; ++c)
        for (int64_t b = 0; b < nband; ++b) {
          int64_t idx;
          if (interleave == 0)       idx = (b * ysize + (y + r)) * xsize + (x + c);
          else if (interleave == 1)  idx = ((y + r) * nband + b) * xsize + (x + c);
          else                       idx = ((y + r) * xsize + (x + c)) * nband + b;
          out[(r * w + c) * nband + b] = decode_at(base + idx * bpp, dtype, big_endian);
        }
    return true;
  }
};

// ---------------------------------------------------------------------------
// handle registry
// ---------------------------------------------------------------------------

std::mutex g_mu;
std::map<int64_t, Raster*> g_rasters;
std::atomic<int64_t> g_next{1};

Raster* get(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_rasters.find(h);
  return it == g_rasters.end() ? nullptr : it->second;
}

// open a raster by magic sniff (TIFF then ENVI), unregistered
Raster* open_any(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  char magic[4] = {0};
  f.read(magic, 4);
  Raster* r = nullptr;
  if ((magic[0] == 'I' && magic[1] == 'I') || (magic[0] == 'M' && magic[1] == 'M')) {
    auto* t = new TiffRaster();
    if (t->open(path)) r = t; else delete t;
  }
  if (!r) {
    auto* e = new EnviRaster();
    if (e->open(path)) r = e; else delete e;
  }
  return r;
}

// tile-grid math (parity: data/tile_grid.py, reference data_utils.py:57-176)
struct Grid {
  int64_t xsize, ysize, patch_w, patch_h, pad_x, pad_y;
  std::vector<int64_t> xs, xe, ys, ye;

  Grid(int64_t X, int64_t Y, int64_t pw, int64_t ph, int64_t px, int64_t py)
      : xsize(X), ysize(Y), patch_w(pw), patch_h(ph), pad_x(px), pad_y(py) {
    int64_t sx = pw - 2 * px, sy = ph - 2 * py;
    for (int64_t s = 0; s < X; s += sx) {
      xs.push_back(s);
      if (s + sx < X) xe.push_back(s + sx);
    }
    xe.push_back(X);
    for (int64_t s = 0; s < Y; s += sy) {
      ys.push_back(s);
      if (s + sy < Y) ye.push_back(s + sy);
    }
    ye.push_back(Y);
  }

  void slices(int64_t item, int64_t* read, int64_t* write) const {
    int64_t ny = (int64_t)ys.size();
    int64_t ix = item / ny, iy = item % ny;
    int64_t cx0 = xs[ix], cx1 = xe[ix], cy0 = ys[iy], cy1 = ye[iy];
    int64_t x_ori = (cx0 - pad_x > 0) ? 0 : pad_x;
    int64_t y_ori = (cy0 - pad_y > 0) ? 0 : pad_y;
    int64_t rx0 = (cx0 - pad_x > 0) ? cx0 - pad_x : 0;
    int64_t ry0 = (cy0 - pad_y > 0) ? cy0 - pad_y : 0;
    int64_t rx1 = (cx1 + pad_x < xsize) ? cx1 + pad_x : xsize;
    int64_t ry1 = (cy1 + pad_y < ysize) ? cy1 + pad_y : ysize;
    read[0] = rx0; read[1] = ry0; read[2] = rx1 - rx0; read[3] = ry1 - ry0;
    write[0] = x_ori; write[1] = y_ori; write[2] = rx1 - rx0; write[3] = ry1 - ry0;
  }
};

}  // namespace

extern "C" {

int64_t tio_open(const char* path) {
  Raster* r = open_any(path);
  if (!r) return 0;
  std::lock_guard<std::mutex> lk(g_mu);
  int64_t h = g_next++;
  g_rasters[h] = r;
  return h;
}

void tio_info(int64_t h, int64_t* xsize, int64_t* ysize, int64_t* nband) {
  Raster* r = get(h);
  if (!r) { *xsize = *ysize = *nband = 0; return; }
  *xsize = r->xsize; *ysize = r->ysize; *nband = r->nband;
}

int tio_read_window_f32(int64_t h, int64_t x, int64_t y, int64_t w, int64_t hh,
                        float* out) {
  Raster* r = get(h);
  if (!r) return -1;
  return r->read_window(x, y, w, hh, out) ? 0 : -2;
}

// Assemble a batch of normalized zero-padded tile canvases for a scene pair.
// out_x/out_y: (n, patch_h, patch_w, nband) float32 HWC, pre-zeroed by caller
// mean/std: per-band arrays (nband) per temporal image, rounded to float32;
// (v - mean) / std runs in float32, as the Python Normalize (numpy float32)
// and the device feeds do, so every feed gives the same bits.
int tio_assemble_batch(
    int64_t hx, int64_t hy, const int64_t* items, int64_t n,
    int64_t patch_w, int64_t patch_h, int64_t pad_x, int64_t pad_y,
    const double* mean_x, const double* std_x,
    const double* mean_y, const double* std_y,
    float* out_x, float* out_y, int n_threads) {
  Raster* rx = get(hx);
  Raster* ry = get(hy);
  if (!rx || !ry) return -1;
  int64_t nb = rx->nband;
  Grid grid(rx->xsize, rx->ysize, patch_w, patch_h, pad_x, pad_y);
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  std::vector<float> fmean[2], fstd[2];
  for (int img = 0; img < 2; ++img) {
    const double* mean = img == 0 ? mean_x : mean_y;
    const double* stdd = img == 0 ? std_x : std_y;
    for (int64_t b = 0; mean && b < nb; ++b) {
      fmean[img].push_back((float)mean[b]);
      fstd[img].push_back((float)stdd[b]);
    }
  }

  auto worker = [&]() {
    std::vector<float> tmp;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t read[4], write[4];
      grid.slices(items[i], read, write);
      int64_t rw = read[2], rh = read[3];
      tmp.resize((size_t)(rw * rh * nb));
      for (int img = 0; img < 2; ++img) {
        Raster* r = img == 0 ? rx : ry;
        const double* mean = img == 0 ? mean_x : mean_y;
        float* out = img == 0 ? out_x : out_y;
        if (!r->read_window(read[0], read[1], rw, rh, tmp.data())) {
          err.store(1);
          return;
        }
        float* canvas = out + (size_t)i * patch_h * patch_w * nb;
        for (int64_t ry_ = 0; ry_ < rh; ++ry_) {
          float* dst = canvas + ((write[1] + ry_) * patch_w + write[0]) * nb;
          const float* src = tmp.data() + ry_ * rw * nb;
          if (mean) {
            for (int64_t c = 0; c < rw; ++c)
              for (int64_t b = 0; b < nb; ++b)
                dst[c * nb + b] = (src[c * nb + b] - fmean[img][b]) / fstd[img][b];
          } else {
            memcpy(dst, src, (size_t)rw * nb * sizeof(float));
          }
        }
      }
    }
  };

  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load() ? -2 : 0;
}

// Native sample dtype of an open raster as a DType code
// (0 u8, 1 i8, 2 u16, 3 i16, 4 u32, 5 i32, 6 f32, 7 f64); -1 bad handle.
int tio_dtype(int64_t h) {
  Raster* r = get(h);
  return r ? r->dtype_code() : -1;
}

// Raw-dtype variant of tio_assemble_batch: tile canvases in the raster's
// NATIVE dtype with NO normalization — the host->device payload for the
// device_normalize path (affine (v-mean)/std + zero-pad masking runs on the
// GPU instead; 2-4x fewer upload bytes for the common u16/u8 rasters).
// out_code must equal tio_dtype(hx) (== tio_dtype(hy)); integral samples
// round-trip exactly through the f32 decode (values < 2^24). out_x/out_y:
// (n, patch_h, patch_w, nband) in that dtype, pre-zeroed by the caller.
int tio_assemble_batch_raw(
    int64_t hx, int64_t hy, const int64_t* items, int64_t n,
    int64_t patch_w, int64_t patch_h, int64_t pad_x, int64_t pad_y,
    void* out_x, void* out_y, int out_code, int n_threads) {
  Raster* rx = get(hx);
  Raster* ry = get(hy);
  if (!rx || !ry) return -1;
  if (rx->dtype_code() != out_code || ry->dtype_code() != out_code) return -4;
  int64_t nb = rx->nband;
  int64_t osz = dtype_size((DType)out_code);
  if (osz == 0 || out_code == 7) return -4;  // F64 canvases unsupported
  Grid grid(rx->xsize, rx->ysize, patch_w, patch_h, pad_x, pad_y);
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};

  auto store = [out_code](uint8_t* dst, float v) {
    switch ((DType)out_code) {
      case DType::U8:  *dst = (uint8_t)v; break;
      case DType::I8:  *(int8_t*)dst = (int8_t)v; break;
      case DType::U16: { uint16_t t = (uint16_t)v; memcpy(dst, &t, 2); } break;
      case DType::I16: { int16_t t = (int16_t)v; memcpy(dst, &t, 2); } break;
      case DType::U32: { uint32_t t = (uint32_t)v; memcpy(dst, &t, 4); } break;
      case DType::I32: { int32_t t = (int32_t)v; memcpy(dst, &t, 4); } break;
      default:         memcpy(dst, &v, 4); break;  // F32
    }
  };

  auto worker = [&]() {
    std::vector<float> tmp;
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int64_t read[4], write[4];
      grid.slices(items[i], read, write);
      int64_t rw = read[2], rh = read[3];
      tmp.resize((size_t)(rw * rh * nb));
      for (int img = 0; img < 2; ++img) {
        Raster* r = img == 0 ? rx : ry;
        uint8_t* out = (uint8_t*)(img == 0 ? out_x : out_y);
        if (!r->read_window(read[0], read[1], rw, rh, tmp.data())) {
          err.store(1);
          return;
        }
        uint8_t* canvas = out + (size_t)i * patch_h * patch_w * nb * osz;
        for (int64_t ry_ = 0; ry_ < rh; ++ry_) {
          uint8_t* dst =
              canvas + (size_t)((write[1] + ry_) * patch_w + write[0]) * nb * osz;
          const float* src = tmp.data() + ry_ * rw * nb;
          for (int64_t c = 0; c < rw * nb; ++c)
            store(dst + (size_t)c * osz, src[c]);
        }
      }
    }
  };

  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load() ? -2 : 0;
}

// Read n whole slice images (each exactly (h, w, nband)) into out
// (n, h, w, nband) f32, optionally per-band normalized ((v-mean)/std) —
// the WHU slice-image batch path (PIL per-file reads in the reference,
// data_utils.py:449-563). Returns 0 ok, -2 open/read failure, -3 shape
// mismatch.
int tio_read_files_f32(const char** paths, int64_t n, int64_t w, int64_t h,
                       int64_t nband, const double* mean, const double* stdd,
                       float* out, int n_threads) {
  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  std::vector<float> fmean, fstd;  // float32 arithmetic, as tio_assemble_batch
  for (int64_t b = 0; mean && b < nband; ++b) {
    fmean.push_back((float)mean[b]);
    fstd.push_back((float)stdd[b]);
  }

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n || err.load()) break;
      Raster* r = open_any(paths[i]);
      if (!r) { err.store(-2); break; }
      float* dst = out + (size_t)i * h * w * nband;
      if (r->xsize != w || r->ysize != h || r->nband != nband) {
        delete r;
        err.store(-3);
        break;
      }
      bool ok = r->read_window(0, 0, w, h, dst);
      delete r;
      if (!ok) { err.store(-2); break; }
      if (mean) {
        for (int64_t p = 0; p < h * w; ++p)
          for (int64_t b = 0; b < nband; ++b)
            dst[p * nband + b] = (dst[p * nband + b] - fmean[b]) / fstd[b];
      }
    }
  };

  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
}

void tio_close(int64_t h) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_rasters.find(h);
  if (it != g_rasters.end()) {
    delete it->second;
    g_rasters.erase(it);
  }
}

}  // extern "C"
