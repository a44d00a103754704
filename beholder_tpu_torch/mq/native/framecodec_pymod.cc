// CPython C-API module for the AMQP frame scanner — the zero-overhead
// binding of framecodec.cc's scan loop (the port's own copy of the
// reference's native/framecodec_pymod.cc).
//
// The ctypes binding (beholder_tpu_torch/mq/_native.py) pays a fixed cost
// per call in Python — ctypes argument marshaling for the 8-argument call,
// buffer-export setup and scratch-array readback — which at wire-sized
// chunks (a few frames per TCP recv) can exceed the pure-Python walk's.
// This module does the whole scan-and-slice-payloads pass in one C call:
// it takes any buffer-exporting object and returns (frames, consumed),
// with payloads as fresh bytes objects (scan) or views (scan_views).
//
// Built at first use with the host C++ compiler (g++ -O2 -shared -fPIC
// -I<sysconfig include> -> framecodec_ext-<hash><EXT_SUFFIX> under _build/
// beside this file) and loaded by beholder_tpu_torch/mq/_native.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>

namespace {
constexpr uint8_t kFrameEnd = 0xCE;
constexpr Py_ssize_t kHeaderSize = 7;  // type(1) + channel(2) + size(4)

// How a scanned payload is materialized: bytes copy (scan) or a
// zero-copy sub-view of the caller's buffer (scan_views). Everything
// else about the walk — header decode, bounds, the kFrameEnd check and
// its error offset — is shared, so the two entry points (and the ctypes
// backend layered on framecodec.cc's identical loop) cannot drift.
typedef PyObject* (*PayloadFn)(void* ctx, const uint8_t* buf,
                               Py_ssize_t off, Py_ssize_t size);

// Shared frame walk over buf[0..len): returns a (frames, consumed)
// tuple, or nullptr with a Python error set (bad frame end reports the
// bad frame's start offset; the caller keeps everything before it
// consumed).
PyObject* scan_core(const uint8_t* buf, Py_ssize_t len,
                    PayloadFn make_payload, void* ctx) {
  PyObject* frames = PyList_New(0);
  if (frames == nullptr) {
    return nullptr;
  }

  Py_ssize_t pos = 0;
  while (true) {
    if (len - pos < kHeaderSize) break;
    const unsigned type = buf[pos];
    const unsigned channel = (unsigned)buf[pos + 1] << 8 | buf[pos + 2];
    const uint32_t size = (uint32_t)buf[pos + 3] << 24 |
                          (uint32_t)buf[pos + 4] << 16 |
                          (uint32_t)buf[pos + 5] << 8 | buf[pos + 6];
    const Py_ssize_t total = kHeaderSize + (Py_ssize_t)size + 1;
    if (len - pos < total) break;
    if (buf[pos + kHeaderSize + size] != kFrameEnd) {
      Py_DECREF(frames);
      PyErr_Format(PyExc_ValueError, "bad frame end at buffer offset %zd",
                   pos);
      return nullptr;
    }
    PyObject* payload =
        make_payload(ctx, buf, pos + kHeaderSize, (Py_ssize_t)size);
    if (payload == nullptr) {
      Py_DECREF(frames);
      return nullptr;
    }
    PyObject* tup = Py_BuildValue("(IIN)", type, channel, payload);
    if (tup == nullptr || PyList_Append(frames, tup) != 0) {
      Py_XDECREF(tup);
      Py_DECREF(frames);
      return nullptr;
    }
    Py_DECREF(tup);
    pos += total;
  }

  return Py_BuildValue("(Nn)", frames, pos);
}

PyObject* payload_bytes(void* ctx, const uint8_t* buf, Py_ssize_t off,
                        Py_ssize_t size) {
  (void)ctx;
  return PyBytes_FromStringAndSize(reinterpret_cast<const char*>(buf + off),
                                   size);
}

// zero-copy payload: a sub-view of the master memoryview (the slice
// holds a reference chain master -> caller's buffer, so lifetime is
// refcounted, not borrowed)
PyObject* payload_view(void* ctx, const uint8_t* buf, Py_ssize_t off,
                       Py_ssize_t size) {
  (void)buf;
  return PySequence_GetSlice(static_cast<PyObject*>(ctx), off, off + size);
}
}  // namespace

// scan_views(buffer) -> (list[(type, channel, payload: memoryview)], consumed)
//
// The batched ingest entry point: ONE C call per socket poll that scans
// every complete frame in the recv buffer and slices each payload as a
// ZERO-COPY memoryview over the caller's buffer (no per-frame bytes
// allocation — the scan() path below copies every payload). Each view
// keeps the underlying buffer alive by refcount, so the caller hands the
// whole batch downstream and lets the buffer generation die when the
// last view does (beholder_tpu_torch/mq/ingest.py owns the generation
// discipline: one fresh buffer per poll, never resized while exported).
static PyObject* scan_views(PyObject* self, PyObject* arg) {
  PyObject* master = PyMemoryView_FromObject(arg);
  if (master == nullptr) {
    return nullptr;
  }
  const Py_buffer* vb = PyMemoryView_GET_BUFFER(master);
  PyObject* result = scan_core(static_cast<const uint8_t*>(vb->buf), vb->len,
                               payload_view, master);
  Py_DECREF(master);
  return result;
}

// scan(buffer) -> (list[(type, channel, payload: bytes)], consumed)
static PyObject* scan(PyObject* self, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) != 0) {
    return nullptr;
  }
  PyObject* result = scan_core(static_cast<const uint8_t*>(view.buf),
                               view.len, payload_bytes, nullptr);
  PyBuffer_Release(&view);
  return result;
}

static PyMethodDef kMethods[] = {
    {"scan", scan, METH_O,
     "scan(buffer) -> (list[(type, channel, payload)], consumed)"},
    {"scan_views", scan_views, METH_O,
     "scan_views(buffer) -> (list[(type, channel, memoryview)], consumed)"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "framecodec_ext",
    "AMQP frame scanner (CPython C-API binding)", -1, kMethods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit_framecodec_ext(void) {
  return PyModule_Create(&kModule);
}
