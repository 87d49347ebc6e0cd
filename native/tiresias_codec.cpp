// Optional compressed-audio codec backend for tiresias.
//
// The reference inherits MP3/OGG/FLAC/... support from aubio_source's
// libav/sndfile backends (/root/reference/src/fp_handler.c:604 — the decode
// call accepts any format the backend reads). This library is the rebuild's
// equivalent: decode via libavformat/libavcodec/libswresample to mono
// float32 at the file's native rate (DEF_AUBIO_SAMPLERATE 0 semantics,
// /root/reference/src/fp_handler.c:37), and encode (for corpus tooling and
// test fixtures) to whatever container the path's extension selects.
//
// Built separately from libtiresias_host.so so the base host library stays
// dependency-free: environments without ffmpeg simply don't get this .so,
// and the Python layer degrades to WAV-only with a warning
// (tiresias_tpu/utils/native.py).
//
// Build: make -C native codec   (produces libtiresias_codec.so)

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#if LIBAVCODEC_VERSION_MAJOR < 59
#error "tiresias_codec requires ffmpeg >= 5.0 (libavcodec 59, AVChannelLayout API)"
#endif

extern "C" {
// Decode any libavformat-supported audio file to mono float32 at native
// rate. On success (*out, *n_samples, *samplerate) are set; the buffer is
// malloc'd and must be released with tir_buffer_free. Returns 0 on success.
int tir_decode_audio(const char* path, float** out, long* n_samples,
                     int* samplerate);
void tir_buffer_free(float* p);
// Encode mono float32 PCM to the container selected by the path's
// extension (.flac/.ogg/.mp3/.wav...), using the muxer's default audio
// codec. Returns 0 on success.
int tir_encode_audio(const char* path, const float* pcm, long n,
                     int samplerate);
const char* tir_codec_version(void);
}

namespace {

constexpr const char* kVersion = "tiresias_codec 0.1.0 (ffmpeg)";

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  ~DecodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

// malloc-backed growable PCM sink: no C++ exception can escape the
// ctypes boundary on allocation failure, and the finished buffer is
// handed to the caller directly — no final vector->malloc memcpy of the
// whole decoded file.
struct PcmSink {
  float* p = nullptr;
  size_t len = 0, cap = 0;
  ~PcmSink() { free(p); }
  bool reserve(size_t need) {
    if (len + need <= cap) return true;
    size_t ncap = cap ? cap : (size_t)1 << 16;
    while (ncap < len + need) {
      if (ncap > (SIZE_MAX / sizeof(float)) / 2) return false;
      ncap *= 2;
    }
    float* np = static_cast<float*>(realloc(p, ncap * sizeof(float)));
    if (!np) return false;
    p = np;
    cap = ncap;
    return true;
  }
  float* release() {
    float* out = p;
    p = nullptr;
    return out;
  }
};

// Convert one decoded frame to mono float32 and append to sink.
int append_converted(SwrContext* swr, const AVFrame* frame, PcmSink* sink) {
  int cap = swr_get_out_samples(swr, frame ? frame->nb_samples : 0);
  if (cap <= 0) return 0;
  if (!sink->reserve((size_t)cap)) return AVERROR(ENOMEM);
  uint8_t* dst[1] = {reinterpret_cast<uint8_t*>(sink->p + sink->len)};
  int got = swr_convert(swr, dst, cap,
                        frame ? const_cast<const uint8_t**>(frame->extended_data)
                              : nullptr,
                        frame ? frame->nb_samples : 0);
  if (got < 0) return got;
  sink->len += (size_t)got;
  return 0;
}

}  // namespace

int tir_decode_audio(const char* path, float** out, long* n_samples,
                     int* samplerate) {
  DecodeCtx c;
  if (avformat_open_input(&c.fmt, path, nullptr, nullptr) < 0) return 1;
  if (avformat_find_stream_info(c.fmt, nullptr) < 0) return 2;
  const AVCodec* codec = nullptr;
  int stream = av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                   &codec, 0);
  if (stream < 0 || !codec) return 3;
  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec) return 4;
  if (avcodec_parameters_to_context(c.dec, c.fmt->streams[stream]->codecpar) <
      0)
    return 5;
  if (avcodec_open2(c.dec, codec, nullptr) < 0) return 6;
  if (c.dec->sample_rate <= 0) return 7;

  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  AVChannelLayout in_layout;
  if (c.dec->ch_layout.nb_channels > 0) {
    av_channel_layout_copy(&in_layout, &c.dec->ch_layout);
  } else {
    av_channel_layout_default(&in_layout, 1);
  }
  // Mono downmix uses swresample's normalized mixing matrix (stereo L/R at
  // 0.5 each == the mean, matching aubio_source's default downmix).
  if (swr_alloc_set_opts2(&c.swr, &mono, AV_SAMPLE_FMT_FLT,
                          c.dec->sample_rate, &in_layout, c.dec->sample_fmt,
                          c.dec->sample_rate, 0, nullptr) < 0) {
    av_channel_layout_uninit(&in_layout);
    return 8;
  }
  av_channel_layout_uninit(&in_layout);
  if (swr_init(c.swr) < 0) return 9;

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  if (!c.pkt || !c.frame) return 10;

  PcmSink pcm;
  auto drain_frames = [&]() -> int {
    for (;;) {
      int rc = avcodec_receive_frame(c.dec, c.frame);
      if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
      if (rc < 0) return 13;
      if (append_converted(c.swr, c.frame, &pcm) < 0) return 14;
      av_frame_unref(c.frame);
    }
  };
  int rc;
  bool eof = false;
  while (!eof) {
    rc = av_read_frame(c.fmt, c.pkt);
    if (rc == AVERROR_EOF) {
      eof = true;
    } else if (rc < 0) {
      return 11;
    } else if (c.pkt->stream_index != stream) {
      av_packet_unref(c.pkt);
      continue;
    }
    // ffmpeg contract: EAGAIN from send_packet means "drain frames, then
    // resend the SAME packet" — dropping it would silently lose audio
    // (wrong fingerprints) with decoders that buffer several frames.
    // Bounded: a decoder that keeps signalling EAGAIN while yielding no
    // frames (a codec bug, not the contract) would otherwise spin this
    // loop forever; 64 drain+resend rounds is far beyond any real
    // decoder's frame-buffer depth.
    int resends = 0;
    for (;;) {
      rc = avcodec_send_packet(c.dec, eof ? nullptr : c.pkt);
      if (rc != AVERROR(EAGAIN)) break;
      if (++resends > 64) { rc = AVERROR(EAGAIN); break; }
      int dr = drain_frames();
      if (dr != 0) return dr;
    }
    if (!eof) av_packet_unref(c.pkt);
    if (rc < 0 && !(eof && rc == AVERROR_EOF)) return 12;
    int dr = drain_frames();
    if (dr != 0) return dr;
  }
  if (append_converted(c.swr, nullptr, &pcm) < 0) return 15;  // drain swr

  *n_samples = (long)pcm.len;
  *samplerate = c.dec->sample_rate;
  *out = pcm.release();  // caller frees via tir_buffer_free
  return 0;
}

void tir_buffer_free(float* p) { free(p); }

// ---------------------------------------------------------------------------
// Encoder (corpus tooling / test fixtures).
// ---------------------------------------------------------------------------

namespace {

struct EncodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* enc = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  bool io_open = false;
  ~EncodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (enc) avcodec_free_context(&enc);
    if (fmt) {
      if (io_open && !(fmt->oformat->flags & AVFMT_NOFILE))
        avio_closep(&fmt->pb);
      avformat_free_context(fmt);
    }
  }
};

int drain_encoder(EncodeCtx* c, AVStream* st) {
  for (;;) {
    int rc = avcodec_receive_packet(c->enc, c->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
    if (rc < 0) return rc;
    av_packet_rescale_ts(c->pkt, c->enc->time_base, st->time_base);
    c->pkt->stream_index = st->index;
    rc = av_interleaved_write_frame(c->fmt, c->pkt);
    if (rc < 0) return rc;
  }
}

}  // namespace

int tir_encode_audio(const char* path, const float* pcm, long n,
                     int samplerate) {
  EncodeCtx c;
  if (avformat_alloc_output_context2(&c.fmt, nullptr, nullptr, path) < 0 ||
      !c.fmt)
    return 1;
  const AVCodec* codec =
      avcodec_find_encoder(c.fmt->oformat->audio_codec);
  if (!codec) return 2;
  AVStream* st = avformat_new_stream(c.fmt, nullptr);
  if (!st) return 3;
  c.enc = avcodec_alloc_context3(codec);
  if (!c.enc) return 4;

  AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
  av_channel_layout_copy(&c.enc->ch_layout, &mono);
  c.enc->sample_rate = samplerate;
  c.enc->sample_fmt = codec->sample_fmts ? codec->sample_fmts[0]
                                         : AV_SAMPLE_FMT_FLTP;
  c.enc->time_base = {1, samplerate};
  // quality-mode (VBR) rather than a fixed bitrate: telephony rates like
  // 8 kHz reject 128 kbps CBR outright in some encoders (libvorbis)
  c.enc->flags |= AV_CODEC_FLAG_QSCALE;
  c.enc->global_quality = 5 * FF_QP2LAMBDA;
  // experimental encoders (e.g. the native vorbis one) need the opt-in
  c.enc->strict_std_compliance = FF_COMPLIANCE_EXPERIMENTAL;
  if (c.fmt->oformat->flags & AVFMT_GLOBALHEADER)
    c.enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(c.enc, codec, nullptr) < 0) return 5;
  if (avcodec_parameters_from_context(st->codecpar, c.enc) < 0) return 6;
  st->time_base = c.enc->time_base;

  if (!(c.fmt->oformat->flags & AVFMT_NOFILE)) {
    if (avio_open(&c.fmt->pb, path, AVIO_FLAG_WRITE) < 0) return 7;
    c.io_open = true;
  }
  if (avformat_write_header(c.fmt, nullptr) < 0) return 8;

  if (swr_alloc_set_opts2(&c.swr, &c.enc->ch_layout, c.enc->sample_fmt,
                          samplerate, &mono, AV_SAMPLE_FMT_FLT, samplerate, 0,
                          nullptr) < 0)
    return 9;
  if (swr_init(c.swr) < 0) return 10;

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  if (!c.pkt || !c.frame) return 11;
  const int chunk = c.enc->frame_size > 0 ? c.enc->frame_size : 4096;
  c.frame->format = c.enc->sample_fmt;
  av_channel_layout_copy(&c.frame->ch_layout, &c.enc->ch_layout);
  c.frame->sample_rate = samplerate;
  c.frame->nb_samples = chunk;
  if (av_frame_get_buffer(c.frame, 0) < 0) return 12;

  long done = 0;
  int64_t pts = 0;
  while (done < n) {
    int todo = (int)((n - done) < chunk ? (n - done) : chunk);
    if (av_frame_make_writable(c.frame) < 0) return 13;
    const uint8_t* src[1] = {
        reinterpret_cast<const uint8_t*>(pcm + done)};
    int got = swr_convert(c.swr, c.frame->extended_data, chunk, src, todo);
    if (got < 0) return 14;
    if (got == 0) { done += todo; continue; }
    c.frame->nb_samples = got;
    c.frame->pts = pts;
    pts += got;
    if (avcodec_send_frame(c.enc, c.frame) < 0) return 15;
    if (drain_encoder(&c, st) < 0) return 16;
    done += todo;
  }
  // drain swr's tail, then flush the encoder
  for (;;) {
    if (av_frame_make_writable(c.frame) < 0) return 13;
    int got = swr_convert(c.swr, c.frame->extended_data, chunk, nullptr, 0);
    if (got <= 0) break;
    c.frame->nb_samples = got;
    c.frame->pts = pts;
    pts += got;
    if (avcodec_send_frame(c.enc, c.frame) < 0) return 15;
    if (drain_encoder(&c, st) < 0) return 16;
  }
  if (avcodec_send_frame(c.enc, nullptr) < 0) return 17;
  if (drain_encoder(&c, st) < 0) return 18;
  if (av_write_trailer(c.fmt) < 0) return 19;
  return 0;
}

const char* tir_codec_version(void) { return kVersion; }
