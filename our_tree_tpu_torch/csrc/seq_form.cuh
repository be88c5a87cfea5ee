// The forms of seq.cu's chained encrypt and the auto form's choice by stream
// count. Plain C++ (no CUDA), so tests/test_torch_seq.py compiles it with g++
// and holds the choice against cuda_aes.SEQ_FORMS.
//
// Crossings, from chip_smoke.py phase 9's forms table (every form at 1 to
// 16,384 streams of 64 blocks, NVIDIA H100 80GB HBM3, 700 W): a form is the
// fastest while its warps fit about one to a sub-partition (132 SMs x 4).
// The 16-lane form (two streams a warp, the shortest path a block) is the
// fastest up to 1,024 streams, the 8-lane form up to 2,048, the 4-lane form
// (the fewest instructions a block of the lane forms) up to 8,192; above it
// the thread form, whose bitsliced block costs a stream the fewest issue
// slots, once every sub-partition is busy.

#pragma once

// Form codes (cuda_aes.SEQ_FORMS): 0 is auto.
enum SeqForm { kSeqAuto = 0, kSeqThread = 1, kSeqLanes4 = 2, kSeqLanes8 = 3, kSeqLanes16 = 4 };

constexpr int kSeqLanes16Max = 1024;
constexpr int kSeqLanes8Max = 2048;
constexpr int kSeqLanes4Max = 8192;

// The form a launch of s streams takes: `form` itself when it names one, the
// auto form's choice for 0, -1 for an unknown code.
inline int seq_form(int s, int form) {
  if (form < kSeqAuto || form > kSeqLanes16) return -1;
  if (form != kSeqAuto) return form;
  if (s <= kSeqLanes16Max) return kSeqLanes16;
  if (s <= kSeqLanes8Max) return kSeqLanes8;
  return s <= kSeqLanes4Max ? kSeqLanes4 : kSeqThread;
}

// Lanes a stream takes in a lane form (4Q: Q lanes a column).
constexpr int seq_lanes(int form) { return 4 << (form - kSeqLanes4); }
