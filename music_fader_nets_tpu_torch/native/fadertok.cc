// fadertok — native host-side tokenizer kernels of the PyTorch port
// (music_fader_nets_tpu_torch), a copy of the JAX package's
// native/fadertok.cc.
//
// The corpus-preprocessing hot loops (performance-token encode/decode and
// the pianoroll event codec) are per-element Python in the reference
// (polyphonic_event_based_v2.py, ptb_v2.py) and in the port's pure-Python
// path. This CPython extension implements them in C++ with identical
// semantics; music_fader_nets_tpu_torch/native/__init__.py builds it with
// g++ at its first use and music_fader_nets_tpu_torch.tokenizer.*
// dispatches here unless FADERNETS_NO_NATIVE=1. Equivalence is pinned by
// tests/test_torch_tokenizer_compat.py.
//
// Vocab layouts: see tokenizer/performance_codec.py (342) and
// tokenizer/event_codec.py (388).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// ---- 342-token performance codec constants ----
constexpr int kEos = 1;
constexpr int kNoteOnBase = 2;
constexpr int kNumPitches = 88;
constexpr int kMinPitch = 21;
constexpr int kNoteOffBase = kNoteOnBase + kNumPitches;   // 90
constexpr int kShiftBase = kNoteOffBase + kNumPitches;    // 178
constexpr int kMaxShift = 100;
constexpr int kVelBase = kShiftBase + kMaxShift;          // 278
constexpr int kVocab = 342;
constexpr int kStepsPerSecond = 100;
constexpr int kVelBinSize = 2;                            // ceil(127/64)

inline int velocity_to_bin(int v) {
  if (v < 1) v = 1;
  if (v > 127) v = 127;
  return (v - 1) / kVelBinSize + 1;
}

struct PerfEvent {
  int64_t step;
  int64_t idx;
  int is_off;
};

// perf_encode(pitch int64[n], velocity int64[n], start f64[n], end f64[n],
//             add_eos int) -> int32[ntok]
PyObject* perf_encode(PyObject*, PyObject* args) {
  PyArrayObject *pitch_a, *vel_a, *start_a, *end_a;
  int add_eos = 0;
  if (!PyArg_ParseTuple(args, "O!O!O!O!i", &PyArray_Type, &pitch_a,
                        &PyArray_Type, &vel_a, &PyArray_Type, &start_a,
                        &PyArray_Type, &end_a, &add_eos))
    return nullptr;
  npy_intp n = PyArray_SIZE(pitch_a);
  const int64_t* pitch = static_cast<int64_t*>(PyArray_DATA(pitch_a));
  const int64_t* vel = static_cast<int64_t*>(PyArray_DATA(vel_a));
  const double* start = static_cast<double*>(PyArray_DATA(start_a));
  const double* end = static_cast<double*>(PyArray_DATA(end_a));

  // notes arrive sorted by (start, pitch); build on/off events
  std::vector<PerfEvent> evs;
  evs.reserve(2 * n);
  for (npy_intp i = 0; i < n; ++i) {
    // Magenta's quantize_to_step: int(seconds * sps + (1 - QUANTIZE_CUTOFF))
    // with cutoff 0.5 — double add then truncate, NOT llround (they differ
    // when x + 0.5 rounds up across an integer, e.g. x = nextafter(.5, 0))
    int64_t on = static_cast<int64_t>(start[i] * kStepsPerSecond + 0.5);
    int64_t off = static_cast<int64_t>(end[i] * kStepsPerSecond + 0.5);
    if (off <= on) off = on + 1;
    evs.push_back({on, i, 0});
    evs.push_back({off, i, 1});
  }
  std::stable_sort(evs.begin(), evs.end(),
                   [](const PerfEvent& a, const PerfEvent& b) {
                     if (a.step != b.step) return a.step < b.step;
                     if (a.idx != b.idx) return a.idx < b.idx;
                     return a.is_off < b.is_off;
                   });

  std::vector<int32_t> toks;
  toks.reserve(4 * n);
  int64_t cur_step = 0;
  int cur_bin = 0;
  for (const auto& e : evs) {
    int64_t gap = e.step - cur_step;
    while (gap > 0) {
      int64_t s = gap < kMaxShift ? gap : kMaxShift;
      toks.push_back(static_cast<int32_t>(kShiftBase + s - 1));
      gap -= s;
    }
    cur_step = e.step;
    int p = static_cast<int>(pitch[e.idx]);
    if (e.is_off) {
      toks.push_back(kNoteOffBase + p - kMinPitch);
    } else {
      int b = velocity_to_bin(static_cast<int>(vel[e.idx]));
      if (b != cur_bin) {
        toks.push_back(kVelBase + b - 1);
        cur_bin = b;
      }
      toks.push_back(kNoteOnBase + p - kMinPitch);
    }
  }
  if (add_eos) toks.push_back(kEos);

  npy_intp dims[1] = {static_cast<npy_intp>(toks.size())};
  PyObject* out = PyArray_SimpleNew(1, dims, NPY_INT32);
  memcpy(PyArray_DATA(reinterpret_cast<PyArrayObject*>(out)), toks.data(),
         toks.size() * sizeof(int32_t));
  return out;
}

// perf_decode(tokens int64[nt], default_velocity int, trailing_steps int)
//   -> (pitch int64[m], velocity int64[m], start_step int64[m],
//       end_step int64[m])  sorted by (start_step, pitch)
PyObject* perf_decode(PyObject*, PyObject* args) {
  PyArrayObject* tok_a;
  int default_vel = 100, trailing = 10;
  if (!PyArg_ParseTuple(args, "O!ii", &PyArray_Type, &tok_a, &default_vel,
                        &trailing))
    return nullptr;
  npy_intp nt = PyArray_SIZE(tok_a);
  const int64_t* toks = static_cast<int64_t*>(PyArray_DATA(tok_a));

  struct Note { int64_t pitch, vel, s, e; };
  std::vector<Note> notes;
  int64_t open_start[128], open_vel[128];
  bool open[128] = {false};
  int64_t step = 0, velocity = default_vel;
  for (npy_intp i = 0; i < nt; ++i) {
    int64_t t = toks[i];
    if (t >= kNoteOnBase && t < kNoteOffBase) {
      int p = static_cast<int>(t - kNoteOnBase + kMinPitch);
      if (open[p]) {
        if (step > open_start[p])
          notes.push_back({p, open_vel[p], open_start[p], step});
      }
      open[p] = true;
      open_start[p] = step;
      open_vel[p] = velocity;
    } else if (t >= kNoteOffBase && t < kShiftBase) {
      int p = static_cast<int>(t - kNoteOffBase + kMinPitch);
      if (open[p]) {
        if (step > open_start[p])
          notes.push_back({p, open_vel[p], open_start[p], step});
        open[p] = false;
      }
    } else if (t >= kShiftBase && t < kVelBase) {
      step += t - kShiftBase + 1;
    } else if (t >= kVelBase && t < kVocab) {
      velocity = kVelBinSize * (t - kVelBase) + 1;
    }
  }
  int64_t end = step + trailing;
  for (int p = 0; p < 128; ++p)
    if (open[p]) {
      int64_t e = end > open_start[p] + 1 ? end : open_start[p] + 1;
      notes.push_back({p, open_vel[p], open_start[p], e});
    }
  std::stable_sort(notes.begin(), notes.end(),
                   [](const Note& a, const Note& b) {
                     if (a.s != b.s) return a.s < b.s;
                     return a.pitch < b.pitch;
                   });

  npy_intp m = static_cast<npy_intp>(notes.size());
  npy_intp dims[1] = {m};
  PyObject* pa = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* va = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* sa = PyArray_SimpleNew(1, dims, NPY_INT64);
  PyObject* ea = PyArray_SimpleNew(1, dims, NPY_INT64);
  auto* pd = static_cast<int64_t*>(PyArray_DATA((PyArrayObject*)pa));
  auto* vd = static_cast<int64_t*>(PyArray_DATA((PyArrayObject*)va));
  auto* sd = static_cast<int64_t*>(PyArray_DATA((PyArrayObject*)sa));
  auto* ed = static_cast<int64_t*>(PyArray_DATA((PyArrayObject*)ea));
  for (npy_intp i = 0; i < m; ++i) {
    pd[i] = notes[i].pitch;
    vd[i] = notes[i].vel;
    sd[i] = notes[i].s;
    ed[i] = notes[i].e;
  }
  return Py_BuildValue("(NNNN)", pa, va, sa, ea);
}

// ---- 388-token pianoroll event codec ----
constexpr int kShiftTok = 130;
constexpr int kOffsetDisp = 131;
constexpr int kVelDisp = 260;

// pr_to_events(pr int64[T,128]) -> int32[ne]
// Semantics identical to event_codec.pitch_lists_to_events (which mirrors
// reference polyphonic_event_based_v2.py:32-81).
PyObject* pr_to_events(PyObject*, PyObject* args) {
  PyArrayObject* pr_a;
  if (!PyArg_ParseTuple(args, "O!", &PyArray_Type, &pr_a)) return nullptr;
  npy_intp T = PyArray_DIM(pr_a, 0);
  const int64_t* pr = static_cast<int64_t*>(PyArray_DATA(pr_a));

  bool held[128] = {false};
  int64_t vel_of[128] = {0};
  std::vector<int32_t> ev;
  ev.reserve(8 * T);

  // step 0: note-on + velocity per sounding pitch, ascending
  for (int p = 0; p < 128; ++p) {
    int64_t v = pr[p];
    if (v > 0) {
      ev.push_back(p);
      ev.push_back(static_cast<int32_t>(v + kVelDisp));
      vel_of[p] = v;
      held[p] = true;
    }
  }
  ev.push_back(kShiftTok);

  for (npy_intp t = 1; t < T; ++t) {
    const int64_t* row = pr + t * 128;
    // offs for vanished pitches (ascending)
    for (int p = 0; p < 128; ++p)
      if (held[p] && row[p] == 0) {
        ev.push_back(p + kOffsetDisp);
        held[p] = false;
      }
    // off for velocity-changed held pitches (ascending == cur order)
    bool restrike[128] = {false};
    for (int p = 0; p < 128; ++p)
      if (held[p] && row[p] > 0 && row[p] != vel_of[p]) {
        ev.push_back(p + kOffsetDisp);
        held[p] = false;
        restrike[p] = true;
      }
    // note-ons: sounding and not held (includes restrikes), ascending
    for (int p = 0; p < 128; ++p)
      if (row[p] > 0 && !held[p]) {
        ev.push_back(p);
        ev.push_back(static_cast<int32_t>(row[p] + kVelDisp));
        vel_of[p] = row[p];
        held[p] = true;
        (void)restrike;
      }
    ev.push_back(kShiftTok);
  }
  for (int p = 0; p < 128; ++p)
    if (held[p]) ev.push_back(p + kOffsetDisp);

  npy_intp dims[1] = {static_cast<npy_intp>(ev.size())};
  PyObject* out = PyArray_SimpleNew(1, dims, NPY_INT32);
  memcpy(PyArray_DATA((PyArrayObject*)out), ev.data(),
         ev.size() * sizeof(int32_t));
  return out;
}

// events_to_pr(events int64[ne]) -> int64[T,128]
PyObject* events_to_pr(PyObject*, PyObject* args) {
  PyArrayObject* ev_a;
  if (!PyArg_ParseTuple(args, "O!", &PyArray_Type, &ev_a)) return nullptr;
  npy_intp ne = PyArray_SIZE(ev_a);
  const int64_t* ev = static_cast<int64_t*>(PyArray_DATA(ev_a));

  int cur_count[128] = {0};           // multiset: duplicate onsets possible
  int64_t vel_of[128] = {0};
  bool has_vel[128] = {false};
  int prev_onset = 0;
  std::vector<std::vector<int64_t>> rows;   // per step: 128 velocities
  for (npy_intp i = 0; i < ne; ++i) {
    int64_t e = ev[i];
    if (e == kShiftTok) {
      std::vector<int64_t> row(128, 0);
      // pitch 0 excluded on decode — reference quirk
      for (int p = 1; p < 128; ++p)
        if (cur_count[p] > 0) row[p] = has_vel[p] ? vel_of[p] : 100;
      rows.push_back(std::move(row));
    } else if (e == 128 || e == 129 || e == 259) {
      continue;
    } else if (e < kOffsetDisp) {
      cur_count[e]++;
      prev_onset = static_cast<int>(e);
    } else if (e >= kOffsetDisp && e < kVelDisp &&
               cur_count[e - kOffsetDisp] > 0) {
      cur_count[e - kOffsetDisp]--;
    } else if (e > kVelDisp) {
      if (cur_count[prev_onset] > 0) {
        vel_of[prev_onset] = e - kVelDisp;
        has_vel[prev_onset] = true;
      }
    }
  }
  npy_intp T = static_cast<npy_intp>(rows.size());
  npy_intp dims[2] = {T, 128};
  PyObject* out = PyArray_SimpleNew(2, dims, NPY_INT64);
  auto* od = static_cast<int64_t*>(PyArray_DATA((PyArrayObject*)out));
  for (npy_intp t = 0; t < T; ++t)
    memcpy(od + t * 128, rows[t].data(), 128 * sizeof(int64_t));
  return out;
}

PyMethodDef kMethods[] = {
    {"perf_encode", perf_encode, METH_VARARGS,
     "notes (sorted by start,pitch) -> 342-vocab performance tokens"},
    {"perf_decode", perf_decode, METH_VARARGS,
     "performance tokens -> (pitch, velocity, start_step, end_step)"},
    {"pr_to_events", pr_to_events, METH_VARARGS,
     "pianoroll -> 388-vocab event stream"},
    {"events_to_pr", events_to_pr, METH_VARARGS,
     "388-vocab event stream -> pianoroll"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "fadertok",
                       "native tokenizer kernels", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_fadertok(void) {
  import_array();
  return PyModule_Create(&kModule);
}
