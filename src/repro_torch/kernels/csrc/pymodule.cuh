// The C entry points of a kernel source as functions of a Python
// extension module (METH_FASTCALL): pointers and the stream as Python
// ints, then the sizes and factors, in the order of the C signature; each
// returns its cudaError_t, and repro_error_string(err) names it. A ctypes
// call of the same arguments costs microseconds of host time more, and
// the main path's calls of the SRHT transpose and the codecs are small,
// so the host's launch path is most of their time.
//
// A source includes this after <Python.h> and lists its entry points in a
// PyMethodDef table with REPRO_METHOD(name), and REPRO_ERROR_STRING_METHOD
// where its wrapper names launch errors through the module.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <tuple>
#include <type_traits>
#include <utility>

namespace {

template <typename A>
A from_py(PyObject* o) {
  if constexpr (std::is_pointer_v<A>) {
    return static_cast<A>(PyLong_AsVoidPtr(o));
  } else if constexpr (std::is_same_v<A, double>) {
    return PyFloat_AsDouble(o);
  } else if constexpr (std::is_same_v<A, long long>) {
    return PyLong_AsLongLong(o);
  } else {
    static_assert(std::is_same_v<A, int>);
    const long v = PyLong_AsLong(o);
    if (v < INT_MIN || v > INT_MAX) PyErr_SetString(PyExc_OverflowError, "int argument out of range");
    return (int)v;
  }
}

template <typename... A, size_t... I>
PyObject* call_entry(cudaError_t (*fn)(A...), PyObject* const* args, std::index_sequence<I...>) {
  const std::tuple<A...> a{from_py<A>(args[I])...};  // left to right
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong((long)std::apply(fn, a));
}

template <typename... A>
PyObject* call_entry(cudaError_t (*fn)(A...), PyObject* const* args, Py_ssize_t nargs) {
  if (nargs != (Py_ssize_t)sizeof...(A)) {
    PyErr_Format(PyExc_TypeError, "expected %d arguments, got %zd", (int)sizeof...(A), nargs);
    return nullptr;
  }
  return call_entry(fn, args, std::index_sequence_for<A...>{});
}

template <auto Fn>
PyObject* py_entry(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  return call_entry(Fn, args, nargs);
}

[[maybe_unused]] PyObject* py_error_string(PyObject*, PyObject* arg) {
  const long err = PyLong_AsLong(arg);
  if (err == -1 && PyErr_Occurred()) return nullptr;
  return PyUnicode_FromString(cudaGetErrorString((cudaError_t)err));
}

}  // namespace

#define REPRO_METHOD(name) \
  {#name, reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(py_entry<name>)), \
   METH_FASTCALL, nullptr}

#define REPRO_ERROR_STRING_METHOD {"repro_error_string", py_error_string, METH_O, nullptr}
