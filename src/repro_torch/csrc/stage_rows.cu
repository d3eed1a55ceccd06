// Host routine: query rows of Python floats into a float32 staging buffer.
//
// `stage_rows(rows, out, n_out, width, taken)` walks `rows` (a list or
// tuple of rows) and fills the row-major (n_out, width) float32 buffer
// `out`.  Row i < n_out is taken when it is a tuple or list (exact types)
// of at most `width` items that are all exact Python floats: item j
// becomes `(float)` of its double (the IEEE round to nearest even that
// numpy's float64 -> float32 cast gives, NaN, infinities, subnormals and
// overflow to infinity included), the rest of the row is zero, and
// `taken[i]` is 1.  Every other row of `out` is zero-filled and left to the
// caller.  `taken` holds one zeroed byte per row of `rows`; the routine
// sets `taken[i]` to 1 for each row it took.  Returns the rows taken.
//
// It reads borrowed references only and must run with the GIL held: call
// it through a `ctypes.PyDLL` handle, never a `ctypes.CDLL` one (which
// releases the GIL around the call).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string.h>

static bool take_row(PyObject* row, float* dst, int width) {
  if (!PyTuple_CheckExact(row) && !PyList_CheckExact(row)) return false;
  const Py_ssize_t n = PySequence_Fast_GET_SIZE(row);
  if (n > width) return false;
  PyObject** items = PySequence_Fast_ITEMS(row);
  for (Py_ssize_t j = 0; j < n; ++j) {
    PyObject* x = items[j];
    if (!PyFloat_CheckExact(x)) return false;
    dst[j] = (float)PyFloat_AS_DOUBLE(x);
  }
  memset(dst + n, 0, sizeof(float) * (size_t)(width - n));
  return true;
}

extern "C" int stage_rows(PyObject* rows, float* out, int n_out, int width,
                          unsigned char* taken) {
  Py_ssize_t n_in = 0;
  PyObject** items = nullptr;
  if (PyList_CheckExact(rows) || PyTuple_CheckExact(rows)) {
    n_in = PySequence_Fast_GET_SIZE(rows);
    items = PySequence_Fast_ITEMS(rows);
  }
  int direct = 0;
  for (int i = 0; i < n_out; ++i) {
    float* dst = out + (size_t)i * (size_t)width;
    if (i < n_in && take_row(items[i], dst, width)) {
      taken[i] = 1;
      ++direct;
    } else {
      memset(dst, 0, sizeof(float) * (size_t)width);
    }
  }
  return direct;
}
