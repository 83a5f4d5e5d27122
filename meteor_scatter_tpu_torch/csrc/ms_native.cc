// Native streaming-ingest runtime of meteor_scatter_tpu_torch (a copy of
// native/ms_native.cc, built from here by ops/kernels/_build.py).
//
// The reference has no native code (SURVEY.md §2) — its ingest is Python
// (twitchrealtimehandler / soundfile / scipy.io.wavfile).  For a production
// deployment the host-side feeding path must not stall the device, so this
// library provides:
//
//   * a lock-free single-producer/single-consumer PCM ring buffer with
//     int16 -> float32 conversion on pop (the grabber thread pushes raw
//     stream bytes; the pipeline thread pops device-ready blocks),
//   * a chunked WAV reader (PCM16/PCM32/float32, mono-collapsing) that
//     streams arbitrarily large files without loading them,
//   * a segment assembler enforcing the fixed segment contract of the
//     monitor loop (prime_detection.py:150 length check).
//
// C ABI only — consumed from Python via ctypes
// (meteor_scatter_tpu_torch/io/native.py).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer (int16 in, float32 out)
// ---------------------------------------------------------------------------

struct MsRing {
  int16_t* buf;
  size_t capacity;                 // power of two
  size_t mask;
  std::atomic<uint64_t> head{0};   // written by producer
  std::atomic<uint64_t> tail{0};   // written by consumer
  std::atomic<uint64_t> dropped{0};
};

static size_t next_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

void* ms_ring_create(size_t capacity_samples) {
  size_t cap = next_pow2(capacity_samples);
  MsRing* r = new (std::nothrow) MsRing();
  if (!r) return nullptr;
  r->buf = new (std::nothrow) int16_t[cap];
  if (!r->buf) {
    delete r;
    return nullptr;
  }
  r->capacity = cap;
  r->mask = cap - 1;
  return r;
}

void ms_ring_destroy(void* h) {
  MsRing* r = static_cast<MsRing*>(h);
  if (!r) return;
  delete[] r->buf;
  delete r;
}

size_t ms_ring_capacity(void* h) { return static_cast<MsRing*>(h)->capacity; }

size_t ms_ring_available(void* h) {
  MsRing* r = static_cast<MsRing*>(h);
  return static_cast<size_t>(r->head.load(std::memory_order_acquire) -
                             r->tail.load(std::memory_order_acquire));
}

uint64_t ms_ring_dropped(void* h) {
  return static_cast<MsRing*>(h)->dropped.load(std::memory_order_relaxed);
}

// Push int16 samples; returns number actually stored (excess is counted as
// dropped — a live stream must not block the producer).
size_t ms_ring_push_i16(void* h, const int16_t* data, size_t n) {
  MsRing* r = static_cast<MsRing*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  size_t free_space = r->capacity - static_cast<size_t>(head - tail);
  size_t to_write = n < free_space ? n : free_space;
  for (size_t i = 0; i < to_write; ++i) {
    r->buf[(head + i) & r->mask] = data[i];
  }
  r->head.store(head + to_write, std::memory_order_release);
  if (to_write < n) {
    r->dropped.fetch_add(n - to_write, std::memory_order_relaxed);
  }
  return to_write;
}

// Pop up to n samples as float32 scaled to [-1, 1); returns count popped.
size_t ms_ring_pop_f32(void* h, float* out, size_t n) {
  MsRing* r = static_cast<MsRing*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  size_t avail = static_cast<size_t>(head - tail);
  size_t to_read = n < avail ? n : avail;
  constexpr float kScale = 1.0f / 32768.0f;
  for (size_t i = 0; i < to_read; ++i) {
    out[i] = static_cast<float>(r->buf[(tail + i) & r->mask]) * kScale;
  }
  r->tail.store(tail + to_read, std::memory_order_release);
  return to_read;
}

// Blocking-style segment pop: only succeeds when a full segment is ready.
// Returns 1 and fills `out` when seg_samples were popped, 0 otherwise.
int ms_ring_pop_segment_f32(void* h, float* out, size_t seg_samples) {
  if (ms_ring_available(h) < seg_samples) return 0;
  size_t got = ms_ring_pop_f32(h, out, seg_samples);
  return got == seg_samples ? 1 : 0;
}

// ---------------------------------------------------------------------------
// Chunked WAV reader
// ---------------------------------------------------------------------------

struct MsWav {
  FILE* f;
  int fs;
  int channels;
  int bits;
  int fmt;  // 1 = PCM, 3 = float (WAVE_FORMAT_EXTENSIBLE resolved at open)
  long long n_frames;
  long long pos_frames;
  long long data_offset;
};

void* ms_wav_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char id[4];
  uint32_t sz;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "RIFF", 4) != 0) goto fail;
  if (std::fread(&sz, 4, 1, f) != 1) goto fail;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "WAVE", 4) != 0) goto fail;
  {
    MsWav* w = new (std::nothrow) MsWav();
    if (!w) goto fail;
    w->f = f;
    w->pos_frames = 0;
    w->data_offset = -1;
    long long data_size = 0;
    while (std::fread(id, 1, 4, f) == 4 && std::fread(&sz, 4, 1, f) == 1) {
      if (std::memcmp(id, "fmt ", 4) == 0) {
        uint16_t fmt, ch, balign, bits;
        uint32_t fs, brate;
        if (std::fread(&fmt, 2, 1, f) != 1) break;
        std::fread(&ch, 2, 1, f);
        std::fread(&fs, 4, 1, f);
        std::fread(&brate, 4, 1, f);
        std::fread(&balign, 2, 1, f);
        std::fread(&bits, 2, 1, f);
        long consumed = 16;
        if (fmt == 0xFFFE && sz >= 40) {
          // WAVE_FORMAT_EXTENSIBLE (SDR/DAW writers): the real format tag
          // is the first two bytes of the SubFormat GUID, after
          // cbSize/validbits/channel-mask — resolve it so a plain PCM16
          // capture with an extensible header decodes instead of silently
          // matching no branch in ms_wav_read_f32
          uint16_t cbsize = 0, validbits = 0, subfmt = 0;
          uint32_t chmask = 0;
          std::fread(&cbsize, 2, 1, f);
          std::fread(&validbits, 2, 1, f);
          std::fread(&chmask, 4, 1, f);
          std::fread(&subfmt, 2, 1, f);
          consumed = 26;
          fmt = subfmt;
        }
        std::fseek(f, sz - consumed + (sz & 1), SEEK_CUR);
        w->fmt = fmt;
        w->channels = ch;
        w->fs = static_cast<int>(fs);
        w->bits = bits;
      } else if (std::memcmp(id, "data", 4) == 0) {
        w->data_offset = std::ftell(f);
        data_size = sz;
        std::fseek(f, sz + (sz & 1), SEEK_CUR);
      } else {
        std::fseek(f, sz + (sz & 1), SEEK_CUR);
      }
    }
    // only combinations ms_wav_read_f32 can decode may open — anything
    // else (24-bit PCM, float64, ...) must fail loudly here rather than
    // stream silent zeros to the detector
    if (w->data_offset < 0 || w->channels <= 0 || w->bits <= 0 ||
        !((w->fmt == 3 && w->bits == 32) ||
          (w->fmt == 1 && (w->bits == 16 || w->bits == 32)))) {
      delete w;
      goto fail;
    }
    w->n_frames = data_size / (w->channels * (w->bits / 8));
    std::fseek(f, w->data_offset, SEEK_SET);
    return w;
  }
fail:
  std::fclose(f);
  return nullptr;
}

int ms_wav_info(void* h, int* fs, int* channels, int* bits, long long* n_frames) {
  MsWav* w = static_cast<MsWav*>(h);
  if (!w) return 0;
  *fs = w->fs;
  *channels = w->channels;
  *bits = w->bits;
  *n_frames = w->n_frames;
  return 1;
}

// Read up to n frames, collapse to mono (first channel), scaled float32.
long long ms_wav_read_f32(void* h, float* out, long long n) {
  MsWav* w = static_cast<MsWav*>(h);
  long long remaining = w->n_frames - w->pos_frames;
  if (n > remaining) n = remaining;
  if (n <= 0) return 0;

  const int ch = w->channels;
  const int bytes = w->bits / 8;
  const long long frame_bytes = static_cast<long long>(ch) * bytes;
  constexpr long long kChunk = 65536;
  static thread_local char buf[kChunk];

  long long done = 0;
  while (done < n) {
    long long want = n - done;
    long long fit = kChunk / frame_bytes;
    if (want > fit) want = fit;
    size_t got = std::fread(buf, static_cast<size_t>(frame_bytes), static_cast<size_t>(want), w->f);
    if (got == 0) break;
    for (size_t i = 0; i < got; ++i) {
      const char* p = buf + i * frame_bytes;
      float v = 0.0f;
      if (w->fmt == 3 && w->bits == 32) {
        std::memcpy(&v, p, 4);
      } else if (w->fmt == 1 && w->bits == 16) {
        int16_t s;
        std::memcpy(&s, p, 2);
        v = static_cast<float>(s) / 32768.0f;
      } else if (w->fmt == 1 && w->bits == 32) {
        int32_t s;
        std::memcpy(&s, p, 4);
        v = static_cast<float>(s) / 2147483648.0f;
      }
      out[done + static_cast<long long>(i)] = v;
    }
    done += static_cast<long long>(got);
  }
  w->pos_frames += done;
  return done;
}

void ms_wav_close(void* h) {
  MsWav* w = static_cast<MsWav*>(h);
  if (!w) return;
  std::fclose(w->f);
  delete w;
}

// ---------------------------------------------------------------------------
// Background pump: WAV -> ring on a dedicated producer thread
// ---------------------------------------------------------------------------
//
// Gives the SPSC ring a true concurrent producer so the Python/device
// consumer overlaps file IO with compute (the deployment shape of the
// monitor loop, where the grabber thread and the pipeline run in
// parallel — prime_detection.py:49-57's TwitchAudioGrabber is its own
// thread too).  Unlike a live source, a file producer is replayable, so
// the pump applies *backpressure* (waits for ring space) instead of
// dropping; ring drops remain the live-source overflow signal.
//
// Samples convert to the ring's int16 domain with round-to-nearest and
// clamping.  For PCM16 WAVs this is a bit-exact round trip (s/32768.0f
// is exact in float32 and scales back to s); float32 WAVs quantize.

struct MsPump {
  MsWav* wav;    // owned
  MsRing* ring;  // borrowed
  std::thread th;
  std::atomic<int> running{0};
  std::atomic<int> stop_flag{0};
  std::atomic<long long> frames_pushed{0};
  size_t chunk;
  double pace;  // 0 = unpaced; else multiples of realtime (needs wav->fs)
};

static void ms_pump_main(MsPump* p) {
  const size_t chunk = p->chunk;
  float* fbuf = new (std::nothrow) float[chunk];
  int16_t* ibuf = new (std::nothrow) int16_t[chunk];
  if (!fbuf || !ibuf) {
    delete[] fbuf;
    delete[] ibuf;
    p->running.store(0, std::memory_order_release);
    return;
  }
  const auto t0 = std::chrono::steady_clock::now();
  const double fs = static_cast<double>(p->wav->fs > 0 ? p->wav->fs : 1);
  while (!p->stop_flag.load(std::memory_order_acquire)) {
    long long got = ms_wav_read_f32(p->wav, fbuf, static_cast<long long>(chunk));
    if (got <= 0) break;  // end of file
    for (long long i = 0; i < got; ++i) {
      float v = fbuf[i] * 32768.0f;
      if (v > 32767.0f) v = 32767.0f;
      if (v < -32768.0f) v = -32768.0f;
      ibuf[i] = static_cast<int16_t>(v >= 0.0f ? v + 0.5f : v - 0.5f);
    }
    size_t done = 0;
    while (done < static_cast<size_t>(got) &&
           !p->stop_flag.load(std::memory_order_acquire)) {
      // only offer what fits — a full-ring push would count the excess as
      // dropped, and pump overflow is backpressure, not loss.  SPSC: only
      // the consumer advances tail, so free space can't shrink under us.
      size_t used = static_cast<size_t>(
          p->ring->head.load(std::memory_order_relaxed) -
          p->ring->tail.load(std::memory_order_acquire));
      size_t free_space = p->ring->capacity - used;
      size_t want = static_cast<size_t>(got) - done;
      if (want > free_space) want = free_space;
      if (want == 0) {
        std::this_thread::sleep_for(std::chrono::microseconds(200));
        continue;
      }
      done += ms_ring_push_i16(p->ring, ibuf + done, want);
    }
    long long pushed =
        p->frames_pushed.fetch_add(static_cast<long long>(done),
                                   std::memory_order_relaxed) +
        static_cast<long long>(done);
    if (p->pace > 0.0) {
      // sleep until wall clock catches up with pushed/(fs*pace)
      const double target_s = static_cast<double>(pushed) / (fs * p->pace);
      for (;;) {
        const double el = std::chrono::duration<double>(
                              std::chrono::steady_clock::now() - t0)
                              .count();
        if (el >= target_s || p->stop_flag.load(std::memory_order_acquire))
          break;
        const double wait = target_s - el;
        std::this_thread::sleep_for(std::chrono::duration<double>(
            wait < 0.01 ? wait : 0.01));
      }
    }
  }
  delete[] fbuf;
  delete[] ibuf;
  p->running.store(0, std::memory_order_release);
}

void* ms_pump_start(const char* path, void* ring, size_t chunk_frames,
                    double pace_factor) {
  if (!ring || chunk_frames == 0) return nullptr;
  MsWav* w = static_cast<MsWav*>(ms_wav_open(path));
  if (!w) return nullptr;
  MsPump* p = new (std::nothrow) MsPump();
  if (!p) {
    ms_wav_close(w);
    return nullptr;
  }
  p->wav = w;
  p->ring = static_cast<MsRing*>(ring);
  p->chunk = chunk_frames;
  p->pace = pace_factor;
  p->running.store(1, std::memory_order_release);
  p->th = std::thread(ms_pump_main, p);
  return p;
}

int ms_pump_running(void* h) {
  return static_cast<MsPump*>(h)->running.load(std::memory_order_acquire);
}

long long ms_pump_frames(void* h) {
  return static_cast<MsPump*>(h)->frames_pushed.load(std::memory_order_relaxed);
}

// Signal stop, join, close the WAV, free the pump.  Safe after EOF too.
void ms_pump_stop(void* h) {
  MsPump* p = static_cast<MsPump*>(h);
  if (!p) return;
  p->stop_flag.store(1, std::memory_order_release);
  if (p->th.joinable()) p->th.join();
  ms_wav_close(p->wav);
  delete p;
}

}  // extern "C"
