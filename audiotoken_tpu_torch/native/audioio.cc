// audioio.cc — the host's streaming audio decoder (libav), for
// audiotoken_tpu_torch; a copy of audiotoken_tpu/native/audioio.cc.
//
// Demuxes and decodes any container libavformat reads (wav, flac, mp3, ogg,
// opus, ...) to mono float32 at the stream's own sample rate; channels are
// mixed down by an explicit mean, as io/audio.py:convert_audio does.
// Resampling is not done here: the Python layer applies the
// torchaudio-parity polyphase resampler (io/resample.py) to each chunk.
//
// Built at first use by io/_native.py (g++ -O2 -fPIC -shared, linked to
// libavformat, libavcodec and libavutil) and bound with ctypes through
// its plain C interface.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
}

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Decoder {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* codec = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;
  AVIOContext* avio = nullptr;  // only for in-memory inputs
  std::vector<uint8_t> mem;     // backing store for in-memory inputs
  size_t mem_pos = 0;
  int stream_index = -1;
  int sample_rate = 0;
  int channels = 0;
  bool draining = false;
  bool eof = false;
  // decoded mono samples not yet handed out: vector + read offset
  // (bulk appends/copies; compacted lazily)
  std::vector<float> buffer;
  size_t buf_pos = 0;
  char error[256] = {0};

  size_t buffered() const { return buffer.size() - buf_pos; }
  void compact() {
    if (buf_pos > (1u << 20) && buf_pos * 2 > buffer.size()) {
      buffer.erase(buffer.begin(), buffer.begin() + buf_pos);
      buf_pos = 0;
    }
  }
};

// Convert one decoded AVFrame to mono float32, appended to d->buffer.
bool frame_to_mono(Decoder* d, const AVFrame* f) {
  const int n = f->nb_samples;
  const int ch = f->ch_layout.nb_channels;
  const AVSampleFormat sf = static_cast<AVSampleFormat>(f->format);
  const bool planar = av_sample_fmt_is_planar(sf);
  const AVSampleFormat base = av_get_packed_sample_fmt(sf);
  const float inv_ch = 1.0f / static_cast<float>(ch);

  auto sample = [&](int c, int i) -> float {
    const uint8_t* data = planar ? f->extended_data[c] : f->extended_data[0];
    const int idx = planar ? i : i * ch + c;
    switch (base) {
      case AV_SAMPLE_FMT_FLT:
        return reinterpret_cast<const float*>(data)[idx];
      case AV_SAMPLE_FMT_DBL:
        return static_cast<float>(reinterpret_cast<const double*>(data)[idx]);
      case AV_SAMPLE_FMT_S16:
        return reinterpret_cast<const int16_t*>(data)[idx] / 32768.0f;
      case AV_SAMPLE_FMT_S32:
        return reinterpret_cast<const int32_t*>(data)[idx] / 2147483648.0f;
      case AV_SAMPLE_FMT_U8:
        return (reinterpret_cast<const uint8_t*>(data)[idx] - 128) / 128.0f;
      case AV_SAMPLE_FMT_S64:
        return static_cast<float>(
            reinterpret_cast<const int64_t*>(data)[idx] /
            9223372036854775808.0);
      default:
        return 0.0f;
    }
  };

  if (base != AV_SAMPLE_FMT_FLT && base != AV_SAMPLE_FMT_DBL &&
      base != AV_SAMPLE_FMT_S16 && base != AV_SAMPLE_FMT_S32 &&
      base != AV_SAMPLE_FMT_U8 && base != AV_SAMPLE_FMT_S64) {
    snprintf(d->error, sizeof(d->error), "unsupported sample format %d", sf);
    return false;
  }

  // Bulk fast paths for the common decoder outputs.
  if (ch == 1 && base == AV_SAMPLE_FMT_FLT) {  // flt/fltp mono
    const float* p = reinterpret_cast<const float*>(f->extended_data[0]);
    d->buffer.insert(d->buffer.end(), p, p + n);
    return true;
  }
  size_t base_idx = d->buffer.size();
  d->buffer.resize(base_idx + n);
  float* out = d->buffer.data() + base_idx;
  if (ch == 1 && base == AV_SAMPLE_FMT_S16) {
    const int16_t* p = reinterpret_cast<const int16_t*>(f->extended_data[0]);
    constexpr float kS = 1.0f / 32768.0f;
    for (int i = 0; i < n; ++i) out[i] = p[i] * kS;
    return true;
  }
  if (ch == 2 && base == AV_SAMPLE_FMT_S16 && !planar) {
    const int16_t* p = reinterpret_cast<const int16_t*>(f->extended_data[0]);
    constexpr float kS = 0.5f / 32768.0f;
    for (int i = 0; i < n; ++i)
      out[i] = (static_cast<float>(p[2 * i]) + p[2 * i + 1]) * kS;
    return true;
  }
  if (ch == 2 && base == AV_SAMPLE_FMT_FLT && planar) {
    const float* l = reinterpret_cast<const float*>(f->extended_data[0]);
    const float* r = reinterpret_cast<const float*>(f->extended_data[1]);
    for (int i = 0; i < n; ++i) out[i] = 0.5f * (l[i] + r[i]);
    return true;
  }
  for (int i = 0; i < n; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) acc += sample(c, i);
    out[i] = acc * inv_ch;
  }
  return true;
}

// Pump the demuxer/decoder until at least `want` samples are buffered or EOF.
bool pump(Decoder* d, int64_t want) {
  while (!d->eof && static_cast<int64_t>(d->buffered()) < want) {
    int ret = avcodec_receive_frame(d->codec, d->frame);
    if (ret == 0) {
      if (!frame_to_mono(d, d->frame)) return false;
      av_frame_unref(d->frame);
      continue;
    }
    if (ret == AVERROR_EOF) {
      d->eof = true;
      break;
    }
    if (ret != AVERROR(EAGAIN)) {
      snprintf(d->error, sizeof(d->error), "decode error %d", ret);
      return false;
    }
    if (d->draining) continue;
    // Need another packet.
    while (true) {
      ret = av_read_frame(d->fmt, d->pkt);
      if (ret == AVERROR_EOF) {
        avcodec_send_packet(d->codec, nullptr);  // flush
        d->draining = true;
        break;
      }
      if (ret < 0) {
        snprintf(d->error, sizeof(d->error), "demux error %d", ret);
        return false;
      }
      if (d->pkt->stream_index != d->stream_index) {
        av_packet_unref(d->pkt);
        continue;
      }
      ret = avcodec_send_packet(d->codec, d->pkt);
      av_packet_unref(d->pkt);
      if (ret < 0 && ret != AVERROR(EAGAIN)) {
        snprintf(d->error, sizeof(d->error), "send_packet error %d", ret);
        return false;
      }
      break;
    }
  }
  return true;
}

int read_mem(void* opaque, uint8_t* buf, int buf_size) {
  Decoder* d = static_cast<Decoder*>(opaque);
  size_t avail = d->mem.size() - d->mem_pos;
  if (avail == 0) return AVERROR_EOF;
  size_t n = std::min(static_cast<size_t>(buf_size), avail);
  memcpy(buf, d->mem.data() + d->mem_pos, n);
  d->mem_pos += n;
  return static_cast<int>(n);
}

int64_t seek_mem(void* opaque, int64_t offset, int whence) {
  Decoder* d = static_cast<Decoder*>(opaque);
  if (whence == AVSEEK_SIZE) return static_cast<int64_t>(d->mem.size());
  size_t base = 0;
  if (whence == SEEK_CUR) base = d->mem_pos;
  else if (whence == SEEK_END) base = d->mem.size();
  int64_t pos = static_cast<int64_t>(base) + offset;
  if (pos < 0 || pos > static_cast<int64_t>(d->mem.size())) return -1;
  d->mem_pos = static_cast<size_t>(pos);
  return pos;
}

Decoder* open_common(Decoder* d) {
  if (avformat_find_stream_info(d->fmt, nullptr) < 0) return nullptr;
  d->stream_index =
      av_find_best_stream(d->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (d->stream_index < 0) return nullptr;
  AVStream* st = d->fmt->streams[d->stream_index];
  const AVCodec* dec = avcodec_find_decoder(st->codecpar->codec_id);
  if (!dec) return nullptr;
  d->codec = avcodec_alloc_context3(dec);
  if (!d->codec ||
      avcodec_parameters_to_context(d->codec, st->codecpar) < 0 ||
      avcodec_open2(d->codec, dec, nullptr) < 0)
    return nullptr;
  d->sample_rate = st->codecpar->sample_rate;
  d->channels = st->codecpar->ch_layout.nb_channels;
  d->pkt = av_packet_alloc();
  d->frame = av_frame_alloc();
  return (d->pkt && d->frame) ? d : nullptr;
}

}  // namespace

extern "C" {

void ati_close(void* h);

void* ati_open(const char* path) {
  Decoder* d = new Decoder();
  if (avformat_open_input(&d->fmt, path, nullptr, nullptr) < 0 ||
      !open_common(d)) {
    ati_close(d);  // a failed avformat_open_input has freed and nulled fmt
    return nullptr;
  }
  return d;
}

void* ati_open_bytes(const uint8_t* data, int64_t size, const char* hint) {
  Decoder* d = new Decoder();
  d->mem.assign(data, data + size);
  constexpr int kBufSize = 1 << 16;
  uint8_t* iobuf = static_cast<uint8_t*>(av_malloc(kBufSize));
  d->avio = avio_alloc_context(iobuf, kBufSize, 0, d, read_mem, nullptr, seek_mem);
  d->fmt = avformat_alloc_context();
  d->fmt->pb = d->avio;
  const AVInputFormat* in_fmt =
      (hint && hint[0]) ? av_find_input_format(hint) : nullptr;
  if (avformat_open_input(&d->fmt, nullptr, in_fmt, nullptr) < 0 ||
      !open_common(d)) {
    ati_close(d);  // frees the caller-owned avio as well
    return nullptr;
  }
  return d;
}

int ati_sample_rate(void* h) { return static_cast<Decoder*>(h)->sample_rate; }
int ati_channels(void* h) { return static_cast<Decoder*>(h)->channels; }

// Estimated total frames from container duration; -1 if unknown.
int64_t ati_duration_frames(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  AVStream* st = d->fmt->streams[d->stream_index];
  if (st->duration > 0)
    return av_rescale_q(st->duration, st->time_base,
                        AVRational{1, d->sample_rate});
  if (d->fmt->duration > 0)
    return av_rescale(d->fmt->duration, d->sample_rate, AV_TIME_BASE);
  return -1;
}

// Read up to max_frames mono float32 samples. Returns frames written,
// 0 on EOF, -1 on error (ati_error() has details).
int64_t ati_read(void* h, float* out, int64_t max_frames) {
  Decoder* d = static_cast<Decoder*>(h);
  if (!pump(d, max_frames)) return -1;
  int64_t n = std::min<int64_t>(max_frames, static_cast<int64_t>(d->buffered()));
  memcpy(out, d->buffer.data() + d->buf_pos, n * sizeof(float));
  d->buf_pos += n;
  d->compact();
  return n;
}

const char* ati_error(void* h) { return static_cast<Decoder*>(h)->error; }

void ati_close(void* h) {
  Decoder* d = static_cast<Decoder*>(h);
  if (d->frame) av_frame_free(&d->frame);
  if (d->pkt) av_packet_free(&d->pkt);
  if (d->codec) avcodec_free_context(&d->codec);
  if (d->fmt) avformat_close_input(&d->fmt);
  if (d->avio) {
    av_freep(&d->avio->buffer);
    avio_context_free(&d->avio);
  }
  delete d;
}

}  // extern "C"
