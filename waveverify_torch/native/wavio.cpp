// Native audio ingest for waveverify_torch (the same source as the JAX
// package's extension, built separately under its own module name).
//
// The training input pipeline is host-side work that must keep the card
// fed from a single host process. This extension does the hot ingest path
// in C++ with the GIL released and a thread pool: RIFF/WAV parse,
// PCM{8,16,24,32}/float{32,64} decode, mono mixdown, random crop, and batch
// assembly directly into one contiguous float32 [B, T] buffer.
//
// Python API (module `waveverify_torch.native._wavio`):
//   decode_wav(bytes)                      -> (float32 ndarray [T], int sr)
//   load_crop_batch(paths, crop_len, seed,
//                   num_threads=0)         -> (float32 [B, crop_len],
//                                              int32 [B] source sample rates)
//
// Uses only the CPython C API + NumPy headers (no pybind11).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DecodedAudio {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
  std::string error;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Parse a RIFF/WAVE buffer into mono float32. Handles PCM (8/16/24/32-bit)
// and IEEE float (32/64-bit), arbitrary channel counts (averaged), and
// WAVE_FORMAT_EXTENSIBLE.
DecodedAudio decode_wav_buffer(const uint8_t* data, size_t n) {
  DecodedAudio out;
  if (n < 44 || std::memcmp(data, "RIFF", 4) != 0 ||
      std::memcmp(data + 8, "WAVE", 4) != 0) {
    out.error = "not a RIFF/WAVE file";
    return out;
  }
  size_t pos = 12;
  int channels = 0, bits = 0;
  uint16_t fmt_tag = 0;
  const uint8_t* pcm = nullptr;
  size_t pcm_len = 0;
  while (pos + 8 <= n) {
    const uint8_t* hdr = data + pos;
    uint32_t chunk_len = rd_u32(hdr + 4);
    const uint8_t* body = hdr + 8;
    if (pos + 8 + chunk_len > n) chunk_len = (uint32_t)(n - pos - 8);
    if (std::memcmp(hdr, "fmt ", 4) == 0 && chunk_len >= 16) {
      fmt_tag = rd_u16(body);
      channels = rd_u16(body + 2);
      out.sample_rate = (int)rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (fmt_tag == 0xFFFE && chunk_len >= 40) {  // EXTENSIBLE: real tag at +24
        fmt_tag = rd_u16(body + 24);
      }
    } else if (std::memcmp(hdr, "data", 4) == 0) {
      pcm = body;
      pcm_len = chunk_len;
    }
    pos += 8 + chunk_len + (chunk_len & 1);  // chunks are word-aligned
  }
  if (!pcm || channels <= 0 || bits <= 0) {
    out.error = "missing fmt/data chunk";
    return out;
  }
  const size_t bytes_per_sample = bits / 8;
  const size_t frames = pcm_len / (bytes_per_sample * channels);
  out.samples.resize(frames);
  const float inv_ch = 1.0f / (float)channels;

  auto accumulate = [&](auto decode_one) {
    for (size_t f = 0; f < frames; ++f) {
      float acc = 0.0f;
      const uint8_t* fp = pcm + f * bytes_per_sample * channels;
      for (int c = 0; c < channels; ++c) {
        acc += decode_one(fp + c * bytes_per_sample);
      }
      out.samples[f] = acc * inv_ch;
    }
  };

  if (fmt_tag == 3 && bits == 32) {  // IEEE float32
    accumulate([](const uint8_t* p) {
      float v;
      std::memcpy(&v, p, 4);
      return v;
    });
  } else if (fmt_tag == 3 && bits == 64) {
    accumulate([](const uint8_t* p) {
      double v;
      std::memcpy(&v, p, 8);
      return (float)v;
    });
  } else if (fmt_tag == 1 && bits == 16) {
    accumulate([](const uint8_t* p) {
      int16_t v = (int16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
      return (float)v / 32768.0f;
    });
  } else if (fmt_tag == 1 && bits == 24) {
    accumulate([](const uint8_t* p) {
      int32_t v = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      return (float)v / 8388608.0f;
    });
  } else if (fmt_tag == 1 && bits == 32) {
    accumulate([](const uint8_t* p) {
      int32_t v;
      std::memcpy(&v, p, 4);
      return (float)((double)v / 2147483648.0);
    });
  } else if (fmt_tag == 1 && bits == 8) {  // unsigned 8-bit
    accumulate([](const uint8_t* p) { return ((float)*p - 128.0f) / 128.0f; });
  } else {
    out.error = "unsupported WAV format (tag=" + std::to_string(fmt_tag) +
                ", bits=" + std::to_string(bits) + ")";
    out.samples.clear();
  }
  return out;
}

DecodedAudio decode_wav_file(const std::string& path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  DecodedAudio out;
  if (!f) {
    out.error = "cannot open " + path;
    return out;
  }
  std::streamsize size = f.tellg();
  f.seekg(0);
  std::vector<uint8_t> buf((size_t)size);
  if (!f.read((char*)buf.data(), size)) {
    out.error = "short read: " + path;
    return out;
  }
  return decode_wav_buffer(buf.data(), buf.size());
}

// --------------------------------------------------------------------------
// Python bindings
// --------------------------------------------------------------------------

PyObject* py_decode_wav(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  DecodedAudio dec;
  Py_BEGIN_ALLOW_THREADS;
  dec = decode_wav_buffer((const uint8_t*)view.buf, (size_t)view.len);
  Py_END_ALLOW_THREADS;
  PyBuffer_Release(&view);
  if (!dec.error.empty()) {
    PyErr_SetString(PyExc_ValueError, dec.error.c_str());
    return nullptr;
  }
  npy_intp dims[1] = {(npy_intp)dec.samples.size()};
  PyObject* arr = PyArray_SimpleNew(1, dims, NPY_FLOAT32);
  if (!arr) return nullptr;
  std::memcpy(PyArray_DATA((PyArrayObject*)arr), dec.samples.data(),
              dec.samples.size() * sizeof(float));
  return Py_BuildValue("(Ni)", arr, dec.sample_rate);
}

// load_crop_batch(paths: list[str], crop_len: int, seed: int, num_threads=0)
PyObject* py_load_crop_batch(PyObject*, PyObject* args) {
  PyObject* path_list;
  Py_ssize_t crop_len;
  unsigned long long seed;
  int num_threads = 0;
  if (!PyArg_ParseTuple(args, "OnK|i", &path_list, &crop_len, &seed,
                        &num_threads))
    return nullptr;
  if (!PyList_Check(path_list)) {
    PyErr_SetString(PyExc_TypeError, "paths must be a list of str");
    return nullptr;
  }
  const Py_ssize_t batch = PyList_Size(path_list);
  std::vector<std::string> paths((size_t)batch);
  for (Py_ssize_t i = 0; i < batch; ++i) {
    PyObject* item = PyList_GetItem(path_list, i);
    const char* s = PyUnicode_AsUTF8(item);
    if (!s) return nullptr;
    paths[(size_t)i] = s;
  }

  npy_intp dims[2] = {(npy_intp)batch, (npy_intp)crop_len};
  PyObject* out = PyArray_ZEROS(2, dims, NPY_FLOAT32, 0);
  npy_intp sr_dims[1] = {(npy_intp)batch};
  PyObject* srs = PyArray_ZEROS(1, sr_dims, NPY_INT32, 0);
  if (!out || !srs) return nullptr;
  float* out_data = (float*)PyArray_DATA((PyArrayObject*)out);
  int32_t* sr_data = (int32_t*)PyArray_DATA((PyArrayObject*)srs);

  std::string first_error;
  {
    Py_BEGIN_ALLOW_THREADS;
    int hw = (int)std::thread::hardware_concurrency();
    int nthreads = num_threads > 0 ? num_threads : (hw > 0 ? hw : 1);
    if (nthreads > (int)batch) nthreads = (int)batch;
    std::atomic<Py_ssize_t> next(0);
    std::vector<std::string> errors((size_t)nthreads);

    auto worker = [&](int tid) {
      for (;;) {
        Py_ssize_t i = next.fetch_add(1);
        if (i >= batch) break;
        DecodedAudio dec = decode_wav_file(paths[(size_t)i]);
        if (!dec.error.empty()) {
          if (errors[(size_t)tid].empty()) errors[(size_t)tid] = dec.error;
          continue;  // row stays zero — fail-soft like the reference loader
        }
        sr_data[i] = dec.sample_rate;
        float* row = out_data + (size_t)i * (size_t)crop_len;
        const size_t n = dec.samples.size();
        if ((Py_ssize_t)n <= crop_len) {
          std::memcpy(row, dec.samples.data(), n * sizeof(float));
        } else {
          // deterministic per-(seed, index) crop offset
          std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)i);
          std::uniform_int_distribution<size_t> dist(0, n - (size_t)crop_len);
          std::memcpy(row, dec.samples.data() + dist(rng),
                      (size_t)crop_len * sizeof(float));
        }
      }
    };

    std::vector<std::thread> pool;
    for (int t = 1; t < nthreads; ++t) pool.emplace_back(worker, t);
    worker(0);
    for (auto& th : pool) th.join();
    for (auto& e : errors)
      if (!e.empty() && first_error.empty()) first_error = e;
    Py_END_ALLOW_THREADS;
  }

  PyObject* err_obj =
      first_error.empty() ? PyUnicode_FromString("")
                          : PyUnicode_FromString(first_error.c_str());
  return Py_BuildValue("(NNN)", out, srs, err_obj);
}

PyMethodDef methods[] = {
    {"decode_wav", py_decode_wav, METH_VARARGS,
     "decode_wav(bytes) -> (float32[T], sample_rate)"},
    {"load_crop_batch", py_load_crop_batch, METH_VARARGS,
     "load_crop_batch(paths, crop_len, seed, num_threads=0) -> "
     "(float32[B,T], int32[B] sample_rates, first_error)"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_wavio",
                      "native WAV ingest for waveverify_torch", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__wavio(void) {
  import_array();
  return PyModule_Create(&module);
}
