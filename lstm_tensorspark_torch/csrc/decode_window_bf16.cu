// The bfloat16 form of the decode window (decode_window.cu), built as a library of
// its own so that its build runs beside the float32 form's: decode_window.cu
// with WINDOW_BF16 defined holds decode_window_bf16_launch alone.

#define WINDOW_BF16
#include "decode_window.cu"
