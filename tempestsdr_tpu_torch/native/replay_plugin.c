// Raw file replay plugin: a test fixture that stands in for a user's
// compiled TSDRPlugin binary.
//
// It exports the ten tsdrplugin_* functions of the reference's binary
// plugin ABI (TSDRPlugin.h:49-60) with the signatures that
// sources/cplugin.py binds, so CPluginSource loads it as it loads any
// plugin. readasync pushes interleaved float32 IQ through the callback,
// items_count counting floats and samples_dropped counting IQ samples,
// reported before the buffer it precedes. No entry point of the receiver
// loads it unless a user names its path.
//
// Parameters, as the reference's RawFile plugin takes them, then options
// only a fixture needs:
//
//     <file> <samplerate> <format> [pace=X] [chunk=N] [inject=AT:N[,AT:N...]]
//
//   format  uint8, int8, int16 or float32, converted to float32 exactly as
//           ops/demod.py's normalize_iq does on the card, so its frames can
//           equal rawfile's;
//   pace    pushes on a monotonic-clock deadline at X times the file's rate
//           (sources/live.py's pacing); 0, the default, is unthrottled;
//   chunk   floats a push, even; default 512 x 1024, the reference's;
//   inject  after push AT (counted from 1 in each stream), skip N samples
//           of the file and report them with the next push: a hardware gap
//           between two deliveries.
//
// Each stream (readasync call) replays the file from its start, in a loop:
// sample positions wrap at its end.
// setsamplerate returns the file's rate. stop makes readasync return
// within one push (or one paced wait). Errors go through
// getlasterrortext.
//
// Like the reference's plugins, its state lives in the loaded library:
// one stream at a time per loaded file. To run several at once, load
// copies of the .so (dlopen shares one path's library).
//
// Build: gcc -O2 -fPIC -shared replay_plugin.c -o replay_plugin.so
// (native/__init__.py build_replay_plugin does it at first use).

#define _GNU_SOURCE
#include <errno.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#define TSDR_OK 0
#define TSDR_ERR_PLUGIN 1
#define TSDR_PLUGIN_PARAMETERS_WRONG 3
#define TSDR_CANNOT_OPEN_DEVICE 5

#define DEFAULT_CHUNK (512 * 1024)
#define MAX_INJECT 64

typedef void (*tsdrplugin_readasync_function)(float *buf, uint64_t items_count, void *ctx,
                                              int64_t samples_dropped);

enum { F_UINT8, F_INT8, F_INT16, F_FLOAT32 };

static const struct {
  const char *name;
  int fmt;
  int size;
} FORMATS[] = {{"uint8", F_UINT8, 1},
               {"int8", F_INT8, 1},
               {"int16", F_INT16, 2},
               {"float32", F_FLOAT32, 4}};

static char err_text[512];
static int fd = -1;
static int fmt, value_size;
static uint32_t rate;
static double pace;
static uint64_t chunk_values = DEFAULT_CHUNK;
static int64_t file_samples;
static int64_t pos;  // the next sample of the file to push
static int n_inject;
static int64_t inject_at[MAX_INJECT], inject_n[MAX_INJECT];
static int running;

// what the fixture did, for tests (replay_plugin_stats)
static int64_t st_pushes, st_samples_pushed, st_samples_injected, st_active, st_readasync_calls,
    st_setsamplerate_calls, st_first_push_ns, st_last_push_ns;
static double st_basefreq = -1.0, st_gain = -1.0;

static int fail(int code, const char *fmt_, const char *arg) {
  snprintf(err_text, sizeof err_text, fmt_, arg);
  return code;
}

static void reset(void) {
  if (fd >= 0) close(fd);
  fd = -1;
  pace = 0.0;
  chunk_values = DEFAULT_CHUNK;
  n_inject = 0;
  pos = 0;
}

void tsdrplugin_getName(char *name) { strcpy(name, "Raw file replay (test fixture)"); }

static int parse_inject(char *spec) {
  for (char *save = NULL, *tok = strtok_r(spec, ",", &save); tok;
       tok = strtok_r(NULL, ",", &save)) {
    char *colon = strchr(tok, ':');
    if (!colon || n_inject == MAX_INJECT) return -1;
    char *end;
    long long at = strtoll(tok, &end, 10);
    if (end != colon || at < 1) return -1;
    long long n = strtoll(colon + 1, &end, 10);
    if (*end || n < 0) return -1;
    inject_at[n_inject] = at;
    inject_n[n_inject++] = n;
  }
  return 0;
}

int tsdrplugin_init(const char *params) {
  reset();
  err_text[0] = 0;
  st_pushes = st_samples_pushed = st_samples_injected = st_readasync_calls = 0;
  st_setsamplerate_calls = st_first_push_ns = st_last_push_ns = 0;
  st_basefreq = st_gain = -1.0;
  char buf[4096];
  if (strlen(params) >= sizeof buf)
    return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "%s", "parameters too long");
  strcpy(buf, params);
  char *save = NULL;
  char *path = strtok_r(buf, " \t", &save);
  char *rate_s = strtok_r(NULL, " \t", &save);
  char *fmt_s = strtok_r(NULL, " \t", &save);
  if (!path || !rate_s || !fmt_s)
    return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "%s",
                "params should be: <file> <samplerate> <format> [pace=X] [chunk=N] "
                "[inject=AT:N,...]");
  char *end;
  double r = strtod(rate_s, &end);
  if (*end || r < 1.0 || r > 4294967295.0)
    return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "bad samplerate '%s'", rate_s);
  rate = (uint32_t)(r + 0.5);
  value_size = 0;
  for (size_t i = 0; i < sizeof FORMATS / sizeof FORMATS[0]; i++)
    if (!strcmp(fmt_s, FORMATS[i].name)) {
      fmt = FORMATS[i].fmt;
      value_size = FORMATS[i].size;
    }
  if (!value_size)
    return fail(TSDR_PLUGIN_PARAMETERS_WRONG,
                "unknown format '%s' (uint8, int8, int16, float32)", fmt_s);
  for (char *opt; (opt = strtok_r(NULL, " \t", &save));) {
    if (!strncmp(opt, "pace=", 5)) {
      pace = strtod(opt + 5, &end);
      if (*end || pace < 0) return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "bad option '%s'", opt);
    } else if (!strncmp(opt, "chunk=", 6)) {
      long long c = strtoll(opt + 6, &end, 10);
      if (*end || c < 2 || c % 2) return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "bad option '%s'", opt);
      chunk_values = (uint64_t)c;
    } else if (!strncmp(opt, "inject=", 7)) {
      if (parse_inject(opt + 7)) return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "bad option '%s'", opt);
    } else {
      return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "unknown option '%s'", opt);
    }
  }
  fd = open(path, O_RDONLY);
  if (fd < 0) {
    snprintf(err_text, sizeof err_text, "cannot open %s: %s", path, strerror(errno));
    return TSDR_CANNOT_OPEN_DEVICE;
  }
  struct stat sb;
  if (fstat(fd, &sb) || sb.st_size < 2 * value_size) {
    reset();
    return fail(TSDR_PLUGIN_PARAMETERS_WRONG, "%s holds no IQ sample", path);
  }
  file_samples = sb.st_size / (2 * value_size);
  return TSDR_OK;
}

uint32_t tsdrplugin_setsamplerate(uint32_t r) {
  (void)r;
  __atomic_add_fetch(&st_setsamplerate_calls, 1, __ATOMIC_RELAXED);
  return rate;  // a file's rate is fixed
}

uint32_t tsdrplugin_getsamplerate(void) { return rate; }

int tsdrplugin_setbasefreq(uint32_t freq) {
  st_basefreq = (double)freq;
  return TSDR_OK;
}

int tsdrplugin_stop(void) {
  __atomic_store_n(&running, 0, __ATOMIC_RELEASE);
  return TSDR_OK;
}

int tsdrplugin_setgain(float gain) {
  st_gain = (double)gain;
  return TSDR_OK;
}

char *tsdrplugin_getlasterrortext(void) { return err_text; }

// n samples from the file at pos, wrapping at its end, into dst
static int read_samples(unsigned char *dst, int64_t n) {
  const int64_t bps = 2 * (int64_t)value_size;
  while (n > 0) {
    int64_t take = file_samples - pos < n ? file_samples - pos : n;
    size_t want = (size_t)(take * bps), got = 0;
    while (got < want) {
      ssize_t r = pread(fd, dst + got, want - got, (off_t)(pos * bps + (int64_t)got));
      if (r <= 0) return -1;
      got += (size_t)r;
    }
    dst += want;
    pos = (pos + take) % file_samples;
    n -= take;
  }
  return 0;
}

// float32 exactly as normalize_iq: (x - off) / scale in f32
static void convert(const unsigned char *raw, float *out, uint64_t n) {
  switch (fmt) {
    case F_UINT8:
      for (uint64_t i = 0; i < n; i++) out[i] = ((float)raw[i] - 128.0f) / 128.0f;
      break;
    case F_INT8:
      for (uint64_t i = 0; i < n; i++) out[i] = (float)(int8_t)raw[i] / 128.0f;
      break;
    case F_INT16:
      for (uint64_t i = 0; i < n; i++) {
        int16_t v;
        memcpy(&v, raw + 2 * i, 2);
        out[i] = (float)v / 32767.0f;
      }
      break;
    default:
      memcpy(out, raw, n * 4);
  }
}

static void add_seconds(struct timespec *t, double s) {
  long long ns = t->tv_nsec + (long long)(s * 1e9);
  t->tv_sec += ns / 1000000000LL;
  t->tv_nsec = ns % 1000000000LL;
}

int tsdrplugin_readasync(tsdrplugin_readasync_function cb, void *ctx) {
  if (fd < 0) return fail(TSDR_ERR_PLUGIN, "%s", "plugin not initialised");
  unsigned char *raw = malloc(chunk_values * value_size);
  float *out = malloc(chunk_values * sizeof(float));
  if (!raw || !out) {
    free(raw);
    free(out);
    return fail(TSDR_ERR_PLUGIN, "%s", "out of memory");
  }
  __atomic_add_fetch(&st_readasync_calls, 1, __ATOMIC_RELAXED);
  __atomic_store_n(&st_active, 1, __ATOMIC_RELEASE);
  __atomic_store_n(&running, 1, __ATOMIC_RELEASE);
  const double push_s = pace > 0 ? (double)(chunk_values / 2) / rate / pace : 0.0;
  struct timespec deadline;
  clock_gettime(CLOCK_MONOTONIC, &deadline);
  pos = 0;  // each stream replays the file from its start
  int64_t pushes = 0, pending = 0;
  int rc = TSDR_OK;
  while (__atomic_load_n(&running, __ATOMIC_ACQUIRE)) {
    if (read_samples(raw, (int64_t)(chunk_values / 2))) {
      rc = fail(TSDR_ERR_PLUGIN, "read failed: %s", strerror(errno));
      break;
    }
    convert(raw, out, chunk_values);
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    const int64_t now_ns = (int64_t)now.tv_sec * 1000000000LL + now.tv_nsec;
    int64_t none = 0;
    __atomic_compare_exchange_n(&st_first_push_ns, &none, now_ns, 0, __ATOMIC_RELAXED,
                                __ATOMIC_RELAXED);
    __atomic_store_n(&st_last_push_ns, now_ns, __ATOMIC_RELAXED);
    cb(out, chunk_values, ctx, pending);
    pending = 0;
    pushes++;
    __atomic_add_fetch(&st_pushes, 1, __ATOMIC_RELAXED);
    __atomic_add_fetch(&st_samples_pushed, (int64_t)(chunk_values / 2), __ATOMIC_RELAXED);
    for (int i = 0; i < n_inject; i++)
      if (inject_at[i] == pushes) {
        pos = (pos + inject_n[i]) % file_samples;
        pending += inject_n[i];
        __atomic_add_fetch(&st_samples_injected, inject_n[i], __ATOMIC_RELAXED);
      }
    if (push_s > 0) {
      add_seconds(&deadline, push_s);
      while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &deadline, NULL) == EINTR) {
      }
    }
  }
  free(raw);
  free(out);
  __atomic_store_n(&st_active, 0, __ATOMIC_RELEASE);
  return rc;
}

void tsdrplugin_cleanup(void) { reset(); }

// Not part of the ABI: what the fixture did since init, for tests. out[0..9]: pushes,
// samples pushed, samples injected, 1 while readasync runs, readasync
// calls, setsamplerate calls, the last base frequency and gain set (-1
// before any), and the monotonic clock's seconds at the first and the
// last push (0 before any), which give the rate the fixture reached.
void replay_plugin_stats(double *out) {
  out[0] = (double)__atomic_load_n(&st_pushes, __ATOMIC_RELAXED);
  out[1] = (double)__atomic_load_n(&st_samples_pushed, __ATOMIC_RELAXED);
  out[2] = (double)__atomic_load_n(&st_samples_injected, __ATOMIC_RELAXED);
  out[3] = (double)__atomic_load_n(&st_active, __ATOMIC_ACQUIRE);
  out[4] = (double)__atomic_load_n(&st_readasync_calls, __ATOMIC_RELAXED);
  out[5] = (double)__atomic_load_n(&st_setsamplerate_calls, __ATOMIC_RELAXED);
  out[6] = st_basefreq;
  out[7] = st_gain;
  out[8] = (double)__atomic_load_n(&st_first_push_ns, __ATOMIC_RELAXED) * 1e-9;
  out[9] = (double)__atomic_load_n(&st_last_push_ns, __ATOMIC_RELAXED) * 1e-9;
}
