// The binding of a library's extern "C" entries to Python: the library is
// itself a CPython extension module (plain C API, no PyTorch header), and
// each entry one METH_FASTCALL function of it.
//
// A launch of a kernel of a few microseconds is paced by the host, and the
// argument conversion of a ctypes call (an object a pointer, the call's
// frame) cost about a microsecond of it.  Here each Python argument goes
// straight to the entry's C type (a pointer from the int of its address,
// int, long long, uint32_t, the stream's raw handle), checked as it goes,
// and the entry runs with the interpreter lock released, as a ctypes call
// does.  A source lists its entries once at its end:
//
//   REDSEC_PY_MODULE(pbs, REDSEC_PY_LAUNCH(redsec_ntt), REDSEC_PY_FN(...))
//
// which defines PyInit_libredsec_pbs, the module of libredsec_pbs.so, with
// the entries and redsec_error_string (the CUDA error's text for a code).
// An entry that launches a kernel (REDSEC_PY_LAUNCH) takes the device index
// the caller means before its own arguments and checks it against the
// current device in C; the others (REDSEC_PY_FN) take their arguments only.
// An entry that fills an array takes its address (ctypes.addressof).
#pragma once

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <tuple>
#include <type_traits>
#include <utility>

namespace redsec::py {

// One argument of C type T from a Python int; false, with the Python error
// set, for an object that is not an int or a value T does not hold.
template <class T>
bool arg(PyObject* o, T* out) {
  if constexpr (std::is_pointer_v<T>) {
    void* p = PyLong_AsVoidPtr(o);
    if (p == nullptr && PyErr_Occurred()) return false;
    *out = static_cast<T>(p);
    return true;
  } else if constexpr (std::is_same_v<T, long long>) {
    *out = PyLong_AsLongLong(o);
    return !(*out == -1 && PyErr_Occurred());
  } else if constexpr (std::is_same_v<T, uint32_t>) {
    const unsigned long long v = PyLong_AsUnsignedLongLong(o);
    if (v == static_cast<unsigned long long>(-1) && PyErr_Occurred()) return false;
    if (v > UINT32_MAX) {
      PyErr_SetString(PyExc_OverflowError, "argument does not fit a uint32");
      return false;
    }
    *out = static_cast<uint32_t>(v);
    return true;
  } else {
    static_assert(std::is_same_v<T, int>, "an entry takes pointers, int, long long, uint32_t");
    const long long v = PyLong_AsLongLong(o);
    if (v == -1 && PyErr_Occurred()) return false;
    if (v < INT_MIN || v > INT_MAX) {
      PyErr_SetString(PyExc_OverflowError, "argument does not fit an int");
      return false;
    }
    *out = static_cast<int>(v);
    return true;
  }
}

template <class F>
struct Signature;

template <class... A>
struct Signature<int (*)(A...)> {
  static constexpr std::size_t arity = sizeof...(A);
  using Args = std::tuple<std::remove_cv_t<A>...>;
};

template <auto F, std::size_t... I>
PyObject* call(PyObject* const* args, std::index_sequence<I...>) {
  typename Signature<decltype(F)>::Args a{};
  if (!(arg(args[I], &std::get<I>(a)) && ...)) return nullptr;
  int code;
  Py_BEGIN_ALLOW_THREADS
  code = std::apply(F, a);
  Py_END_ALLOW_THREADS
  return PyLong_FromLong(code);
}

// The METH_FASTCALL function of entry F: its arguments converted in order,
// F called, its int returned.
template <auto F>
PyObject* entry(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  constexpr std::size_t n = Signature<decltype(F)>::arity;
  if (nargs != static_cast<Py_ssize_t>(n)) {
    PyErr_Format(PyExc_TypeError, "takes %d arguments (%zd given)", static_cast<int>(n), nargs);
    return nullptr;
  }
  return call<F>(args, std::make_index_sequence<n>{});
}

// What a launch entry returns, without calling its C function, when the
// device the caller names is not the current one: the caller then enters
// its device guard and calls again.  CUDA's error codes are not negative.
constexpr int kOtherDevice = -1;

// The METH_FASTCALL function of a launch entry F: the caller's device index
// first, held against the current device (cudaGetDevice, a read of the
// thread's state) before anything else, then F's arguments as ``entry``.
template <auto F>
PyObject* launch_entry(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  constexpr std::size_t n = Signature<decltype(F)>::arity;
  if (nargs != static_cast<Py_ssize_t>(n) + 1) {
    PyErr_Format(PyExc_TypeError, "takes a device and %d arguments (%zd given)",
                 static_cast<int>(n), nargs);
    return nullptr;
  }
  int dev = 0, current = 0;
  if (!arg(args[0], &dev)) return nullptr;
  const cudaError_t e = cudaGetDevice(&current);
  if (e != cudaSuccess) return PyLong_FromLong(e);
  if (current != dev) return PyLong_FromLong(kOtherDevice);
  return call<F>(args + 1, std::make_index_sequence<n>{});
}

inline PyObject* error_string(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  int code = 0;
  if (nargs != 1) {
    PyErr_SetString(PyExc_TypeError, "redsec_error_string takes one argument");
    return nullptr;
  }
  if (!arg(args[0], &code)) return nullptr;
  return PyUnicode_FromString(cudaGetErrorString(static_cast<cudaError_t>(code)));
}

}  // namespace redsec::py

#define REDSEC_PY_FN(name)                                                                \
  PyMethodDef {                                                                           \
    #name, reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(               \
               &redsec::py::entry<&name>)),                                               \
        METH_FASTCALL, nullptr                                                            \
  }

#define REDSEC_PY_LAUNCH(name)                                                            \
  PyMethodDef {                                                                           \
    #name, reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(               \
               &redsec::py::launch_entry<&name>)),                                        \
        METH_FASTCALL, nullptr                                                            \
  }

#define REDSEC_PY_MODULE(stem, ...)                                                       \
  static PyMethodDef redsec_py_methods[] = {                                              \
      PyMethodDef{"redsec_error_string",                                                  \
                  reinterpret_cast<PyCFunction>(                                          \
                      reinterpret_cast<void (*)(void)>(&redsec::py::error_string)),       \
                  METH_FASTCALL, nullptr},                                                \
      __VA_ARGS__,                                                                        \
      PyMethodDef{nullptr, nullptr, 0, nullptr}};                                         \
  static PyModuleDef redsec_py_module = {PyModuleDef_HEAD_INIT, "libredsec_" #stem,       \
                                         nullptr, -1, redsec_py_methods};                 \
  PyMODINIT_FUNC PyInit_libredsec_##stem() { return PyModule_Create(&redsec_py_module); }
