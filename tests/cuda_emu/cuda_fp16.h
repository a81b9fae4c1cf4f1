// fp16 for the CPU stand-in of `cuda_runtime.h`, through _Float16
#pragma once
#include <stdint.h>
#include <string.h>

struct __half {
  uint16_t r;
};
struct __half2 {
  __half x, y;
};
inline float __half2float(__half v) {
  _Float16 h;
  memcpy(&h, &v.r, 2);
  return (float)h;
}
inline __half __float2half(float f) {
  const _Float16 h = (_Float16)f;
  __half r;
  memcpy(&r.r, &h, 2);
  return r;
}
inline __half2 __floats2half2_rn(float a, float b) { return {__float2half(a), __float2half(b)}; }
inline __half __ushort_as_half(unsigned short v) { return __half{v}; }
// lane-wise a - b, rounded to fp16
inline __half2 __hsub2(__half2 a, __half2 b) {
  return {__float2half(__half2float(a.x) - __half2float(b.x)),
          __float2half(__half2float(a.y) - __half2float(b.y))};
}
