// Native host runtime for tiresias.
//
// The reference keeps its hot host paths in C: audio decode via aubio_source
// (/root/reference/src/fp_handler.c:604,633) and file MD5 via OpenSSL
// (/root/reference/src/fp_handler.c:758-805, 4 KiB fread loop, lowercase hex
// digest). This library is the rebuild's equivalent: a dependency-free WAV
// decoder (PCM 8/16/24/32-bit and IEEE float32, mono downmix by averaging,
// matching aubio_source's default) and a self-contained MD5 (RFC 1321
// structure, public-domain-style implementation written for this project).
// Exposed with a C ABI consumed via ctypes (tiresias_tpu/utils/native.py).
//
// Build: make -C native   (produces libtiresias_host.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <new>

extern "C" {
int tir_wav_info(const char* path, int* samplerate, long* n_samples);
int tir_wav_decode(const char* path, float* out, long capacity);
int tir_md5_file(const char* path, char* hex_out /* 33 bytes */);
const char* tir_version(void);
}

namespace {

constexpr const char* kVersion = "tiresias_host 0.1.0";

struct WavFmt {
  uint16_t format = 0;        // 1 = PCM, 3 = IEEE float
  uint16_t channels = 0;
  uint32_t samplerate = 0;
  uint16_t bits = 0;
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

// Parse the RIFF chunk list; tolerate extension chunks (LIST, fact, ...).
// WAVE_FORMAT_EXTENSIBLE (0xFFFE) resolves through the SubFormat GUID's
// leading format tag.
bool parse_wav(FILE* f, WavFmt* out) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  for (;;) {
    unsigned char chunk[8];
    if (fread(chunk, 1, 8, f) != 8) break;
    uint32_t size = rd_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      if (size < 16) return false;  // a shorter fmt cannot hold the fields
      unsigned char fmt[40];
      size_t want = size < sizeof(fmt) ? size : sizeof(fmt);
      if (fread(fmt, 1, want, f) != want) return false;
      // skip the remainder INCLUDING the RIFF odd-size pad byte (every
      // branch must; a quirky writer's odd fmt size would otherwise
      // misalign all following chunk headers)
      long rest = (long)(((size + 1) & ~1u) - want);
      if (rest > 0 && fseek(f, rest, SEEK_CUR) != 0) return false;
      out->format = rd_u16(fmt + 0);
      out->channels = rd_u16(fmt + 2);
      out->samplerate = rd_u32(fmt + 4);
      out->bits = rd_u16(fmt + 14);
      if (out->format == 0xFFFE && size >= 40)
        out->format = rd_u16(fmt + 24);  // SubFormat GUID leading tag
    } else if (memcmp(chunk, "data", 4) == 0) {
      out->data_offset = ftell(f);
      out->data_bytes = size;
      // streaming-convention writers declare 0xFFFFFFFF ("rest of file");
      // the pad-rounded skip of that sentinel is 0, which would leave the
      // loop scanning the PCM payload itself as chunk headers — a byte
      // pattern matching "data"/"fmt " inside loud audio would then
      // corrupt the parse. The payload is everything that remains: stop.
      if (size == 0xFFFFFFFFu) break;
      if (fseek(f, (long)((size + 1) & ~1u), SEEK_CUR) != 0) break;
    } else {
      if (fseek(f, (long)((size + 1) & ~1u), SEEK_CUR) != 0) break;
    }
  }
  if (out->data_offset >= 0) {
    // clamp the declared data size to what the file actually holds:
    // streaming-convention WAVs write 0xFFFFFFFF (and truncated files
    // lie), which would otherwise make the binding allocate gigabytes
    if (fseek(f, 0, SEEK_END) == 0) {
      long end = ftell(f);
      if (end >= out->data_offset) {
        uint64_t avail = (uint64_t)(end - out->data_offset);
        if ((uint64_t)out->data_bytes > avail)
          out->data_bytes = (uint32_t)avail;
      }
    }
  }
  // channel cap: bounds the decode chunk buffer (and no real audio
  // exceeds it; a crafted 65535-channel header would demand ~17 GB)
  return out->data_offset >= 0 && out->channels > 0 && out->channels <= 64 &&
         out->samplerate > 0 &&
         (out->format == 1 || out->format == 3) &&
         (out->bits == 8 || out->bits == 16 || out->bits == 24 ||
          out->bits == 32);
}

long frames_of(const WavFmt& w) {
  long bytes_per_frame = (long)w.channels * (w.bits / 8);
  return bytes_per_frame > 0 ? (long)w.data_bytes / bytes_per_frame : 0;
}

}  // namespace

int tir_wav_info(const char* path, int* samplerate, long* n_samples) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(fopen(path, "rb"), fclose);
  if (!f) return 1;
  WavFmt w;
  if (!parse_wav(f.get(), &w)) return 2;
  *samplerate = (int)w.samplerate;
  *n_samples = frames_of(w);
  return 0;
}

int tir_wav_decode(const char* path, float* out, long capacity) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(fopen(path, "rb"), fclose);
  if (!f) return 1;
  WavFmt w;
  if (!parse_wav(f.get(), &w)) return 2;
  long frames = frames_of(w);
  if (frames > capacity) return 3;
  if (fseek(f.get(), w.data_offset, SEEK_SET) != 0) return 4;

  const int ch = w.channels;
  const int bytes = w.bits / 8;
  const long frame_bytes = (long)ch * bytes;
  constexpr long kChunkFrames = 65536;
  std::unique_ptr<unsigned char[]> buf(
      new (std::nothrow) unsigned char[kChunkFrames * frame_bytes]);
  if (!buf) return 6;  // never throw across the ctypes boundary

  long done = 0;
  while (done < frames) {
    long todo = frames - done;
    if (todo > kChunkFrames) todo = kChunkFrames;
    size_t got = fread(buf.get(), (size_t)frame_bytes, (size_t)todo, f.get());
    if (got == 0) return 5;
    for (long i = 0; i < (long)got; ++i) {
      double acc = 0.0;
      const unsigned char* p = buf.get() + i * frame_bytes;
      for (int c = 0; c < ch; ++c, p += bytes) {
        double v;
        if (w.format == 3 && w.bits == 32) {
          float fv;
          memcpy(&fv, p, 4);
          v = fv;
        } else if (w.bits == 16) {
          int16_t s = (int16_t)rd_u16(p);
          v = s / 32768.0;
        } else if (w.bits == 32) {
          int32_t s = (int32_t)rd_u32(p);
          v = s / 2147483648.0;
        } else if (w.bits == 24) {
          int32_t s = (int32_t)p[0] | ((int32_t)p[1] << 8) |
                      ((int32_t)p[2] << 16);
          if (s & 0x800000) s -= 0x1000000;
          v = s / 8388608.0;
        } else {  // 8-bit unsigned
          v = ((int)p[0] - 128) / 128.0;
        }
        acc += v;
      }
      out[done + i] = (float)(acc / ch);  // mono downmix by mean
    }
    done += (long)got;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// MD5 (RFC 1321). Straightforward from-the-spec implementation.
// ---------------------------------------------------------------------------

namespace {

struct Md5Ctx {
  uint32_t a = 0x67452301, b = 0xefcdab89, c = 0x98badcfe, d = 0x10325476;
  uint64_t total = 0;
  unsigned char buf[64];
  size_t buf_len = 0;
};

uint32_t rotl(uint32_t x, int s) { return (x << s) | (x >> (32 - s)); }

const uint32_t kT[64] = {
    0xd76aa478, 0xe8c7b756, 0x242070db, 0xc1bdceee, 0xf57c0faf, 0x4787c62a,
    0xa8304613, 0xfd469501, 0x698098d8, 0x8b44f7af, 0xffff5bb1, 0x895cd7be,
    0x6b901122, 0xfd987193, 0xa679438e, 0x49b40821, 0xf61e2562, 0xc040b340,
    0x265e5a51, 0xe9b6c7aa, 0xd62f105d, 0x02441453, 0xd8a1e681, 0xe7d3fbc8,
    0x21e1cde6, 0xc33707d6, 0xf4d50d87, 0x455a14ed, 0xa9e3e905, 0xfcefa3f8,
    0x676f02d9, 0x8d2a4c8a, 0xfffa3942, 0x8771f681, 0x6d9d6122, 0xfde5380c,
    0xa4beea44, 0x4bdecfa9, 0xf6bb4b60, 0xbebfbc70, 0x289b7ec6, 0xeaa127fa,
    0xd4ef3085, 0x04881d05, 0xd9d4d039, 0xe6db99e5, 0x1fa27cf8, 0xc4ac5665,
    0xf4292244, 0x432aff97, 0xab9423a7, 0xfc93a039, 0x655b59c3, 0x8f0ccc92,
    0xffeff47d, 0x85845dd1, 0x6fa87e4f, 0xfe2ce6e0, 0xa3014314, 0x4e0811a1,
    0xf7537e82, 0xbd3af235, 0x2ad7d2bb, 0xeb86d391};
const int kS[64] = {7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22, 7, 12, 17, 22,
                    5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20, 5, 9,  14, 20,
                    4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23, 4, 11, 16, 23,
                    6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21, 6, 10, 15, 21};

void md5_block(Md5Ctx* ctx, const unsigned char* p) {
  uint32_t m[16];
  for (int i = 0; i < 16; ++i) m[i] = rd_u32(p + 4 * i);
  uint32_t a = ctx->a, b = ctx->b, c = ctx->c, d = ctx->d;
  for (int i = 0; i < 64; ++i) {
    uint32_t f;
    int g;
    if (i < 16) {
      f = (b & c) | (~b & d);
      g = i;
    } else if (i < 32) {
      f = (d & b) | (~d & c);
      g = (5 * i + 1) & 15;
    } else if (i < 48) {
      f = b ^ c ^ d;
      g = (3 * i + 5) & 15;
    } else {
      f = c ^ (b | ~d);
      g = (7 * i) & 15;
    }
    uint32_t tmp = d;
    d = c;
    c = b;
    b = b + rotl(a + f + kT[i] + m[g], kS[i]);
    a = tmp;
  }
  ctx->a += a;
  ctx->b += b;
  ctx->c += c;
  ctx->d += d;
}

void md5_update(Md5Ctx* ctx, const unsigned char* data, size_t len) {
  ctx->total += len;
  if (ctx->buf_len) {
    size_t take = 64 - ctx->buf_len;
    if (take > len) take = len;
    memcpy(ctx->buf + ctx->buf_len, data, take);
    ctx->buf_len += take;
    data += take;
    len -= take;
    if (ctx->buf_len == 64) {
      md5_block(ctx, ctx->buf);
      ctx->buf_len = 0;
    }
  }
  while (len >= 64) {
    md5_block(ctx, data);
    data += 64;
    len -= 64;
  }
  if (len) {
    memcpy(ctx->buf, data, len);
    ctx->buf_len = len;
  }
}

void md5_final(Md5Ctx* ctx, unsigned char digest[16]) {
  uint64_t bits = ctx->total * 8;
  unsigned char pad = 0x80;
  md5_update(ctx, &pad, 1);
  unsigned char zero = 0;
  while (ctx->buf_len != 56) md5_update(ctx, &zero, 1);
  unsigned char lenb[8];
  for (int i = 0; i < 8; ++i) lenb[i] = (unsigned char)(bits >> (8 * i));
  md5_update(ctx, lenb, 8);
  uint32_t out[4] = {ctx->a, ctx->b, ctx->c, ctx->d};
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      digest[4 * i + j] = (unsigned char)(out[i] >> (8 * j));
}

}  // namespace

int tir_md5_file(const char* path, char* hex_out) {
  std::unique_ptr<FILE, int (*)(FILE*)> f(fopen(path, "rb"), fclose);
  if (!f) return 1;
  Md5Ctx ctx;
  unsigned char buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f.get())) > 0)
    md5_update(&ctx, buf, got);
  if (ferror(f.get())) return 2;  // a truncated digest must not look valid
  unsigned char digest[16];
  md5_final(&ctx, digest);
  static const char* hex = "0123456789abcdef";
  for (int i = 0; i < 16; ++i) {
    hex_out[2 * i] = hex[digest[i] >> 4];
    hex_out[2 * i + 1] = hex[digest[i] & 15];
  }
  hex_out[32] = '\0';
  return 0;
}

const char* tir_version(void) { return kVersion; }
