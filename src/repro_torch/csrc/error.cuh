// The error-string entry point every kernel library of the port exports:
// each launch entry point returns cudaGetLastError(), and the ctypes
// wrapper (kernels/_build.py::check) turns a non-zero code into a message.
// One definition per shared library: each .cu is built into its own .so
// and includes this header once.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
