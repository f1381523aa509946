#!/usr/bin/env python3
"""GPU smoke run of jpeg_tpu_torch: build, check and time the codec's main
path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order (any failure raises and exits non-zero, printing no
result):

1. Require a CUDA device; print ``nvidia-smi``'s card name and power limit
   and the torch / CUDA versions.  The device scan's "device scan rejected"
   RuntimeWarning (``device_scan.scan_offsets_hybrid``, which would return
   the host scanner's starts) is an error for the whole run.
2. Build the CUDA kernels (K1-K10) from ``jpeg_tpu_torch/csrc`` with ``nvcc``
   (into ``build/cuda/``) and print the build time and ptxas' resource use.
3. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (2048x2048 image: N = 49,152 blocks, L = 64), on the
   image's own levels and on adversarial random levels: K1-K3 and K9 (the
   tables encoder, on ``_unit_groups``' tables) must be bit-equal, K9's
   rows also to K1's, K4 equal except +-1 at provable ties
   (``utils/parity.py``).  K2 also at its design's edges, bit-equal to its
   plain version (and to the host C++ stream where its rows are K1's): all
   1-byte (EOB-only) blocks, one block, N = 49,153, blocks of exactly 4W
   bytes, 1- to 4W-byte blocks, caps below and above the stream's length.
   K4 also against the exact (f64) sums of its f32 inputs, with its plain
   version, on the image's levels, on BASELINE (3)'s d = 24 levels (N =
   1,452, K = 576, M = 9,216) and at its design's edges: M = 64, 1,024,
   1,600 and 9,216, and M = 81 at d = 3 (K = 9: its 4-byte copies and
   single-byte stores), at N = 1, 63, 65 and 49,153 (a zero block and
   all-saturating blocks among them), and levels up to 4,095 ... 16,383
   times 1,024 (dequantized values about 2**22 and 2**24); its largest
   error before rounding (``decode_blocks_sums``) is printed at d = 8, 24
   and 3 in units of 2**-23 sum|terms|, beside the full-f32 cuBLAS
   product's.
   K5 runs on the image's pixel blocks with the DFT operator, at d = 8
   (N = 196,608: the three bands at bs 1; four quantizers) and at d = 24
   (N = 2,700, L = 576), and at its design's edges: d = 3, 8 and 24, N =
   1, 63, 65, 127, 129 and 196,609 (2,701 at d = 24) around both tiles'
   row edges, fractional means of 3x3 and 2x2 pixel blocks, x one element
   off 16-byte alignment in every other case, every quantizer (divisors 3
   and 1000): equal to its plain version and to an f64 numpy reference
   except +-1 at provable ties, the flips counted; its largest error
   before the epilogue (``encode_blocks_sums``) at d = 3, 8 and 24, in
   units of 2**-23 sum|terms|, must be within the split's bound B(K).
   K3 also at its design's edges: N = 1, T - 1, T, T + 1 and 49,153 (T
   its tile) at L = 9, 64 and 576, adversarial, all-EOB and all-+-16383
   blocks (a tile span over the staged budget), a buffer longer than its
   stream, and garbage starts (random, descending, P, P + 1, up to P +
   2**40): bit-equal to its plain version and, where the starts are
   true, to the levels.
   The boundary-scan kernels K6-K8 run on the image's three-band stream,
   the adversarial levels' stream, 24 single-byte mutations of the image
   stream and pure garbage bytes: the end table, the starts and the checks
   must be bit-equal to the plain versions', the two-sweep end table
   (``end_table(cap=c)``: K6' twice, c in 1, 4, 12, 1000 and the unit
   budget b and b - 1) bit-equal to the single sweep's, the
   starts must be the host C++ scanner's wherever it accepts every band,
   and a truncated middle band must fail the check.  K10 (the segmented
   scan, ``segment_scan``) runs on the same streams at the wrapper's
   segment length: its check equals K8's everywhere and its starts are
   K8's where the check holds, and on the image's and the adversarial
   stream its starts and status (faults and unsynced walkers) are
   bit-equal to its plain version's.  Then the redesigned
   kernels at their edges, bit-equal to the plain versions: K7 and K8, in
   the form their plan picks and in both forms, at nb in {0, 1, k - 1, k,
   k + 1, 3k + 5, D, D + 1, D + k + 1} (k = ``CHASE_JUMP``, D =
   ``CHASE_DIRECT_MAX``; starts = the host C++ starts), chain starts past
   P, a band whose chain meets ERR at its first step or mid-band, and 64
   chains on one buffer; K6 on a buffer
   longer than ``n_bytes``, a one-block stream, tile boundaries inside
   zero-run chains, 2.9 KB blocks at L = 1024 (walks past the halo read
   global memory), and K6-K8 on the d = 24 stream of BASELINE (3) and an
   adversarial L = 576 stream.  K6' (the capped and resumed walkers) is
   held against its plain versions, bit-equal, on every byte of the image
   stream, a buffer 4,099 bytes longer than its stream, a one-block stream
   below one tile, uniform garbage, the d = 24 stream and the adversarial
   L = 576 stream, at the same caps: the list form
   (``scan_walk_resume``) on q = every byte, every walker live at the cap
   resumed by the list form (all, and the first half by ``n_live``), the
   range form (``scan_walk_capped``: sweep 1's table, and its survivors
   as a set) and the list form's table over them (sweep 2), and the
   tables equal to the single sweep's.  K1 on BASELINE (3)'s d = 24
   levels (N = 1,452, L = 576; its own line in the JSON), and K1 and K9
   at their design's edges (csrc/bit_writer.cuh: groups of 1, 4, 8, 16 or
   32 lanes a block, lane-owned slot ranges, rows staged in shared memory up to
   ``K.ENC_ROW_MAX_WORDS`` words): L = 9, 16, 64, 576 and 1024 (K9 where
   L <= 75), N = 1, 31, 32, 33, the plans' tiles +- 1 and 49,153, W exact,
   W - 1 and W - 3 (truncated rows, exact block bytes) and one word over
   the staged-row budget (the lanes write the global row), on all-zero
   and all-+-16383 blocks, a nonzero only at slot 0 and L - 1, one at
   every lane's first or last slot for every group size, runs of 15 k and
   15 k +- 1 zeros across lane boundaries and the adversarial levels:
   bit-equal to the plain versions, through the wrappers' plans and
   through every group size (``K._encode_rows`` / ``K._encode_tables``,
   uncounted), K9's rows also to K1's and
   ``_unit_groups``' block bytes to K1's, K1 + K2 at W exact to the host
   C++ encoder's stream.
4. Drive the main path, ``compress_ycbcr`` -> ``decompress_to_ycbcr``
   (``scan="host"``: the host C++ boundary scan), at 2048x2048 and
   3840x2160 (qtable, DCT, dct_size 8, block_size 2) with every kernel's
   launch count reset just before and read just after.  Check that each
   band stream is byte-equal to the host C++ encoder's stream of the same
   levels, the container re-parses, the levels agree with the f64
   reference, PSNR is above 30 dB, the planes equal the plain-version
   path's on the card except +-1 at ties, and every kernel of the path
   was launched.  With the caller's
   TF32 switched on, the container is the same bytes and the caller's
   setting is left as it was.  Then drive the host-free path and the rest
   of the API the same way, counts reset just before and read just after:
   ``decompress_to_ycbcr(scan="device")`` and ``decompress_to_device`` must
   give planes bit-equal to the host-scan path's, ``decompress_many`` (both
   scans, mixed sizes) and ``compress_many`` must equal their per-image
   results, a truncated container must raise the host path's error class,
   ``entropy.scan_offsets(scan="device")`` must give each band's host
   starts, the device scan (K10, and K6 + K8) must accept both images'
   streams, each decode must have launched K3 once, and K6, K7, K8 and K10
   must have been launched: K10 once by each device-scan decode of the two
   sizes (16,384 and 32,400 blocks a band), K8 once by a 512x512 decode
   (1,024 blocks a band, K8's short form) whose planes must equal its
   host-scan planes.  Last, the default scan: ``decompress_to_ycbcr(blob)``
   at 3840x2160, counts reset just before, must take the device scan (K10
   launched once, neither K6 nor K8, K3 once) and give the host-scan planes
   bit for bit.
   Phase 4c drives the BASELINE configurations on the synthetic image, each
   through ``compress_ycbcr`` and ``decompress_to_ycbcr`` with both scans,
   counts reset just before and read just after each: (1) bs 4, DCT,
   none; (2) bs 5, qtable (padded: ``sep_pad``); (3) bs 4, d 24, divide
   1000 (padded, L = 576, K4 at M = 9,216); (4a) bs 4, DFT, qtable (the
   joint product, then K4 with the DFT operator); (4b) bs 3, DFT, none
   (ragged: K5), also at 4000x3000; (5) bs 2, divide 2.5 (the truncating
   plain decode).  All at 2048x2048 but the 4000x3000 frame.  Each band
   stream must equal the host C++ encoder's stream of the same levels, the
   levels and planes must be within the tie contract of the f64 references
   (for (5) a numpy f64 ``trunc`` chain), the two scans' planes bit-equal;
   K5 must launch in (4b) only and K4 in every configuration but (5).
   Phase 4d runs the f64 parity mode on the card
   (``dtype=torch.float64``): encoding the golden images must reproduce
   the six ``tests/golden/*.jc`` blobs byte for byte, and decoding them
   (both scans) the manifest's plane hashes.
   Phase 4e drives the other paths, counts reset just before and read just
   after each: ``compress_ycbcr(enc="tables")`` at both main-path sizes
   (containers byte-equal to ``enc="lv"``'s, K9 launched once and K1 never
   per image), ``compress_many(enc="tables")`` (equal to its per-image
   results), ``enc="tables"`` at d = 24 (must raise ``ValueError``); the
   two-sweep end table ``end_table(cap=12)`` on both main-path streams
   (bit-equal to the single sweep, K6' launched twice each); and the step
   pipeline on the card on the 2048x2048 Y band at the main configuration
   (``compress_band_steps`` / ``decompress_band_steps``: f64 bytes equal
   to ``compress_band``'s, f32 levels and planes within the tie contract
   of ``compress_band`` / ``decompress_band``), and the f64 steps on a
   golden configuration (its Y band bytes).
   Phase 4f drives the parallel layer, the CLI and the profiling module,
   counts reset just before and read just after each run: on the 1 x 1
   card mesh, ``parallel.compress_batch`` of 8 x 2048x2048 (bench.py's
   generator, seeds 0-7) at the main path and at the CLI defaults (bs 4)
   must equal ``compress_ycbcr`` per image with device and with host
   entropy (one K1 and one K2 a call with device entropy, none with host
   entropy), and ``decompress_batch`` ``decompress_to_ycbcr`` (one K3 and
   one K4 a call with device entropy); on a 1 x 4 band mesh of the one
   GPU repeated, the same set (four row-band shares: K1-K4 four times
   each), BASELINE config 5's 4 x 3840x2160 set (``compress_batch`` and
   ``decompress_batch``: 135 block rows do not divide over 4, so one
   share), and each band of its first image at the main path, (2) bs 5
   and (3) d 24 / divide 1000: ``compress_plane`` and
   ``compress_plane_device_entropy`` byte-equal to ``compress_band``,
   ``decompress_plane`` equal to ``decompress_band``, one K1-K4 a share.
   Two processes on the GPU over gloo (``chip_smoke.py --gloo-child``, a
   timeout each, killed on failure): ``compress_plane_distributed`` of
   the 4K Y plane, split by rows as the JAX package splits it (1,080
   rows each: block row 67 straddles the two, and its last 8 rows reach
   process 0 in the halo), gives both the serial stream,
   ``decompress_plane_distributed``'s rows reassemble the serial plane,
   and ``compress_batch_distributed``'s manifest over four 2048x2048
   images is identical on both, each blob ``compress_ycbcr``'s, PSNR > 30
   dB.  Where Pillow imports, ``python -m jpeg_tpu_torch batch --mesh
   --verify`` on the 2048x2048 set written as PNGs (containers byte-equal
   to ``compress_ycbcr``'s, mean PSNR > 30 dB) and ``--decompress`` on its
   output, each printing its ``Metrics`` JSON line; else a line says it
   did not run.  Then, printed and not gated: host-clock medians of 3 of
   ``compress_batch`` against ``compress_many`` and a loop of
   ``compress_ycbcr``, ``decompress_batch`` against ``decompress_many``
   and a loop, and a ``StageTimer`` breakdown of one ``compress_batch``
   and of one ``decompress_batch`` call.  K1-K4's lines in the JSON also
   carry ``launches_batch``, their launches in the 1 x 1 mesh's main-path
   batch run.
4g. Run the on-device test suite ``gpu_tests/`` (the counterpart of
   ``tpu_tests/``) in a subprocess, ``python -m pytest gpu_tests -q -o
   addopts= -p no:cacheprovider``, with a timeout of its own; it passes
   only with exit code 0 and every collected case passed (a skip here is
   a failure).  Its passed count and seconds are printed on a line of
   their own.
5. Time encode and decode (host array -> host bytes -> host array) with
   CUDA events, median of 7 after a warm-up, decode with either scan; the
   host-free decode stage by stage; each kernel against its plain version; the pure-Python scanner, the C++
   scanner and the device scan at stream sizes from 256 bytes to 256 KB
   (where the device scan overtakes the pure-Python one); and
   ``compress_many`` / ``decompress_many`` at depth 2 over 8 images of
   2048x2048; K5, K9 and their plain versions (mean of 50 launches) and
   ``_unit_groups``; encode and decode of BASELINE configurations (2), (3),
   (4a) and (4b); encode with ``enc="tables"`` against ``"lv"``, in turns;
   K8's and K10's device kernels on both main-path streams, and K7 / K8
   in both
   forms at nb = D / 2, D, 2D and 4D on prefixes of the 2048x2048 stream
   (where the plan's choice between them shows); the work K6's walks need
   on the 2048x2048 stream (units walked, and the sum over warps of the
   slowest lane's units with one walker per thread and with refilled
   lanes, modelled);
   the two-sweep end table at caps 8, 12 and 20 against the single sweep
   on both main-path streams, and the device kernels of one call of each
   end table and each ``encode_rows`` (torch.profiler; ``end_table(cap=12)``
   checked at two kernels and one memset at most, on both streams); one
   call's device time (CUDA graph) of the end table at cap 0 and
   ``TWO_SWEEP_CAPS``, each sweep alone and the survivors, beside K6's
   byte bound, with sweep 2 on grids of 2, 4 and 8 eighths of a wave
   (``K.SCAN_RESUME_EIGHTHS`` patched, each table checked bit-equal), and
   of the list form on every byte at cap 12 beside its bound; and the step
   pipeline's band round trip against ``compress_band`` /
   ``decompress_band``.  Also the encode by stage (upload, transform,
   phase-1 stats, "K1 + K2", download, pack; the main path and (4b), whose
   transform is K5), the device kernels of one ``deposit_rows`` call (at
   most two) and of one ``decode_stream_blocks`` call (at most one: no
   memset), and K3 at tiles of a quarter, a half, twice and four times
   its plan's on the 2048x2048 and d = 24 streams; the device kernels of
   one call of K1, K9 and K1 at L = 576 (at most one each: no memset), and
   K1 and K9 under every plan of 1, 4, 8, 16 and 32 lanes a block and
   tiles around the plan's (``K._encode_rows`` / ``K._encode_tables``,
   uncounted; one lane a block is one thread a block with the same
   staging), the plan's marked, on the main path's levels, BASELINE (1)'s
   and (2)'s and (K1) (3)'s, every plan's rows bit-equal to the plan's and
   the plan's to the plain version's; and the host time of K1's wrapper
   beside its parts (the launch with a given plan, the plan, the SM
   count).  Each kernel's line in the JSON carries its bound: the larger of its bytes over the card's
   memory rate and its operations over the f32 rate, or for the products
   of K4 and K5 the TF32 tensor-core rate; and for K4 (main path and d = 24, its own
   line) and K5 ``library_ms``, a full-f32 ``torch.matmul`` of the same
   operands; their entries also carry ``error_eps32``, and K1's (main
   path and L = 576, its own line), K9's, K3's, K4's, K5's, K6's, the two
   sweeps of K6' in ``end_table(cap=12)`` (``scan_walk_capped`` and
   ``scan_walk_resume``, each with its own bytes), K7's, K8's and K10's
   (bound: the stream read once and the starts written once) one call's
   device time (``device_ms``: calls captured in a CUDA graph and
   replayed, since back-to-back wrapper calls include the wrappers' host
   work).  K5's product is also timed without its epilogue
   (``encode_blocks_sums``).

The last three lines of standard output are a JSON object of per-kernel
results, the card's ``name, power.limit`` and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SIZES = ((2048, 2048), (2160, 3840))       # (height, width)
REPS = 7
PSNR_MIN_DB = 30.0

KERNEL_INFO = {   # wrapper name -> (source, Pallas kernel it replaces)
    "encode_stream_rows": ("jpeg_tpu_torch/csrc/encode_stream.cu",
                           "jpeg_tpu/ops/pallas_kernels.py:393"),
    "encode_stream_rows_tables": ("jpeg_tpu_torch/csrc/encode_tables.cu",
                                  "jpeg_tpu/ops/pallas_kernels.py:311"),
    "deposit_rows": ("jpeg_tpu_torch/csrc/compact.cu",
                     "jpeg_tpu/ops/pallas_kernels.py:607"),
    "decode_stream_blocks": ("jpeg_tpu_torch/csrc/decode_stream.cu",
                             "jpeg_tpu/ops/pallas_kernels.py:127"),
    "decode_blocks": ("jpeg_tpu_torch/csrc/decode_blocks.cu",
                      "jpeg_tpu/ops/pallas_kernels.py:73"),
    "encode_blocks": ("jpeg_tpu_torch/csrc/encode_blocks.cu",
                      "jpeg_tpu/ops/pallas_kernels.py:63"),
    "scan_walk": ("jpeg_tpu_torch/csrc/scan_walk.cu",
                  "jpeg_tpu/ops/pallas_kernels.py:857"),
    "scan_walk_capped": ("jpeg_tpu_torch/csrc/scan_walk.cu",
                         "jpeg_tpu/ops/pallas_kernels.py:751"),
    "scan_walk_resume": ("jpeg_tpu_torch/csrc/scan_walk.cu",
                         "jpeg_tpu/ops/pallas_kernels.py:751"),
    "chase_starts": ("jpeg_tpu_torch/csrc/chase.cu",
                     "jpeg_tpu/ops/pallas_kernels.py:944"),
    "chase_starts_multi": ("jpeg_tpu_torch/csrc/chase.cu",
                           "jpeg_tpu/ops/pallas_kernels.py:982"),
    "segment_scan": ("jpeg_tpu_torch/csrc/segment_scan.cu",
                     "none: K6 + K8's long form on long bands"),
}
MAIN_PATH = ("encode_stream_rows", "deposit_rows", "decode_stream_blocks",
             "decode_blocks")
HOST_FREE_PATH = ("scan_walk", "chase_starts", "chase_starts_multi",
                  "segment_scan")
# K4 at d = 24 (BASELINE (3)) has its own line in the kernels JSON.
K4_D24 = "decode_blocks[d=24]"
# K1 on BASELINE (3)'s d = 24 levels (L = 576) has its own line too.
K1_L576 = "encode_stream_rows[L=576]"
TABLES_PATH = ("encode_stream_rows_tables", "deposit_rows")
# Kernels whose line also carries one call's device time (a CUDA graph).
DEVICE_TIMED = ("encode_stream_rows", "encode_stream_rows_tables", K1_L576,
                "decode_stream_blocks", "decode_blocks", "encode_blocks",
                K4_D24, "scan_walk", "scan_walk_capped", "scan_walk_resume",
                "chase_starts", "chase_starts_multi", "segment_scan")
# K1's and K9's edge checks: levels per block (K9 where L <= 75), and the
# block counts checked besides the plan's tile T - 1 and T + 1.
K1_EDGE_L = (9, 16, 64, 576, 1024)
K1_EDGE_N = (1, 31, 32, 33, 49153)
TWO_SWEEP_CAPS = (8, 12, 20)
# The caps of K6' checked against the plain versions and the single sweep,
# besides the unit budget b and b - 1.
K6R_EDGE_CAPS = (1, 4, 12, 1000)
# Sweep 2's grids timed, in eighths of a wave (K.SCAN_RESUME_EIGHTHS).
K6R_EIGHTHS = (2, 4, 8)
# The card's published peaks (NVIDIA H100 SXM data sheet, at 700 W): the
# bound of a kernel is the larger of its bytes over the memory rate and its
# operations over the card's peak rate for them: the f32 (non-tensor-core)
# rate, except for the f32 products of K4 and K5, which the TF32 tensor
# cores can do in f32 accuracy (csrc/tc_product.cuh), so the least time the
# card could take for them is at the TF32 dense rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# K4's checks at its design's edges: output widths (d*bs)^2 (bs 1, 4, 5 at
# d 8, bs 4 at d 24, and bs 3 at d 3, whose K = M = 9 take the kernel's
# 4-byte copies and pixel-by-pixel stores), block counts N, and the
# |levels| of the near-2**22 and near-2**24 dequantized values (times a
# divisor of 1024).  Each edge's pixels are also bit-equal to K4's at bs 1
# on the combined ((d*bs)^2-column) operator.
K4_EDGE_M = ((64, 1, 8), (1024, 4, 8), (1600, 5, 8), (9216, 4, 24),
             (81, 3, 3))
K4_EDGE_N = (1, 63, 65, 49153)
K4_BIG_LEVELS = (4095, 4096, 4097, 16383)
EPS32 = 2.0 ** -23
MUTANTS = 24
CROSSOVER_BYTES = (256, 1 << 10, 4 << 10, 16 << 10, 64 << 10, 256 << 10)
MANY = 8
# K5 checks: (dct_size, blocks or None for all of the image's, quantizers)
K5_CASES = ((8, None, (("none", {}), ("qtable", {}), ("discard", {"keep": 3}),
                       ("divide", {"divisor": 3}))),
            (24, 2700, (("none", {}), ("divide", {"divisor": 1000}))))
# K5 at its design's edges: (dct_size, block counts N around both tiles'
# row edges, quantizers; the largest N takes the first two).
K5_EDGE_N = (1, 63, 65, 127, 129, 196609)
K5_EDGES = ((3, K5_EDGE_N, (("none", {}), ("divide", {"divisor": 3}),
                            ("discard", {"keep": 2}),
                            ("divide", {"divisor": 1000}))),
            (8, K5_EDGE_N, (("none", {}), ("divide", {"divisor": 3}),
                            ("qtable", {}), ("discard", {"keep": 3}),
                            ("divide", {"divisor": 1000}))),
            (24, K5_EDGE_N[:5] + (2701,),
             (("none", {}), ("divide", {"divisor": 3}),
              ("discard", {"keep": 3}), ("divide", {"divisor": 1000}))))
# K3's edge checks: coefficients per block.
K3_EDGE_L = (9, 64, 576)
# BASELINE configurations: label, (height, width), block_size, dct_size,
# transform, quantizer.  (4b) is the one that reaches K5; (5) decodes by
# truncation without K4.
BASELINE = (("1", (2048, 2048), 4, 8, "DCT", ("none", {})),
            ("2", (2048, 2048), 5, 8, "DCT", ("qtable", {})),
            ("3", (2048, 2048), 4, 24, "DCT", ("divide", {"divisor": 1000})),
            ("4a", (2048, 2048), 4, 8, "DFT", ("qtable", {})),
            ("4b", (2048, 2048), 3, 8, "DFT", ("none", {})),
            ("4b", (3000, 4000), 3, 8, "DFT", ("none", {})),
            ("5", (2048, 2048), 2, 8, "DCT", ("divide", {"divisor": 2.5})))
TIMED_BASELINE = ("2", "3", "4a", "4b")


def log(*a) -> None:
    print(*a, flush=True)


def synth_image(h: int, w: int, channels: int = 3,
                seed: int = 7) -> np.ndarray:
    """Natural-image-like content: smooth structure + texture + mild noise
    (the generator of bench.py, seed 7)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    out = []
    for c in range(channels):
        plane = (128
                 + 70 * np.sin(x / (17 + 6 * c)) * np.cos(y / (23 - 4 * c))
                 + 30 * np.sin((x + y) / (9 + 2 * c))
                 + 8 * rng.standard_normal((h, w)))
        out.append(np.clip(plane, 0, 255))
    return np.stack(out, axis=-1).astype(np.uint8)


def golden_image(h: int, w: int) -> np.ndarray:
    """The generator of the golden blobs' images (``tests/test_golden.py``,
    seed 42)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    rng = np.random.default_rng(42)
    img = np.stack([128 + 70 * np.sin(x / 13) * np.cos(y / 11),
                    128 + 50 * np.cos(x / 7),
                    np.clip(8 * rng.standard_normal((h, w)) + 128, 0, 255)],
                   -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def adversarial_levels(n: int, L: int, seed: int = 1) -> np.ndarray:
    """Sparse random levels with the codec's edge cases: bare-EOB blocks,
    +-16383, long zero runs (15, 16, 30, 63), dense blocks."""
    rng = np.random.default_rng(seed)
    lv = np.where(rng.random((n, L)) < 0.15,
                  rng.integers(-300, 301, (n, L)), 0)
    kind = rng.integers(0, 6, n)
    lv[kind == 0] = 0                                       # bare EOB
    dense = kind == 1
    lv[dense] = rng.choice([-16383, 16383, -1, 1, 255], (int(dense.sum()), L))
    for k, run in zip((2, 3, 4), (15, 16, 30)):
        sel = kind == k
        lv[sel] = 0
        lv[sel, run] = rng.integers(1, 16384, int(sel.sum()))
        lv[sel, L - 1] = -16383
    lv[kind == 5, :L - 1] = 0                               # run of 63
    return lv.astype(np.int32)


def writer_edge_levels(L: int, lanes: int, seed: int) -> np.ndarray:
    """Blocks at the bit writer's edges for groups of ``lanes`` lanes
    (csrc/bit_writer.cuh: lane k owns slots [k m, (k + 1) m), m = ceil(L /
    lanes)): all zero (EOB only), all +-16383, a nonzero only at slot 0
    and L - 1 (a zero run across every lane), one at every lane's first
    slot and one at every lane's last, and runs of 15 k and 15 k +- 1
    zeros ending at the first slot of lane 1 and of the last lane."""
    rng = np.random.default_rng(seed)
    m = -(-L // lanes)
    firsts = list(range(0, L, m))
    lasts = [min(s + m, L) - 1 for s in firsts]
    rows = [np.zeros(L, np.int64), rng.choice([-16383, 16383], L)]
    for cols in ([0, L - 1], firsts, lasts):
        r = np.zeros(L, np.int64)
        r[cols] = rng.choice([-16383, -1, 1, 255, 16383], len(cols))
        rows.append(r)
    for k in sorted({1, 2, 4, 5, L // 15}):
        for run in (15 * k - 1, 15 * k, 15 * k + 1):
            for b in firsts[1:2] + firsts[-1:]:
                if 0 <= run <= b:
                    r = np.zeros(L, np.int64)
                    r[b] = rng.integers(1, 16384)
                    if b - run - 1 >= 0:
                        r[b - run - 1] = -rng.integers(1, 16384)
                    rows.append(r)
    return np.stack(rows).astype(np.int32)


def writer_levels(n: int, L: int, seed: int, groups) -> np.ndarray:
    """n blocks: ``writer_edge_levels``' for each group size of ``groups``
    first, then ``adversarial_levels`` (L >= 64) or sparse random
    levels with bare-EOB and all-+-16383 blocks; the first 256 shuffled,
    so that short prefixes mix them."""
    rng = np.random.default_rng(seed)
    edge = np.concatenate([writer_edge_levels(L, G, seed + G)
                           for G in groups])
    k = max(n - len(edge), 0)
    if L >= 64:
        rest = adversarial_levels(k, L, seed=seed)
    else:
        rest = np.where(rng.random((k, L)) < 0.3,
                        rng.integers(-16383, 16384, (k, L)), 0)
        rest[::5] = 0
        rest[1::7] = rng.choice([-16383, 16383], rest[1::7].shape)
    lv = np.concatenate([edge, rest.astype(np.int32)])[:n]
    rng.shuffle(lv[:256])
    return np.ascontiguousarray(lv)


def walk_units(buf, n_bytes: int, L: int):
    """(P,) int64: the units each byte's K6 walker takes, the one that
    settles it included (the plain version's step loop,
    ``kernels.scan_walk_plain``, counting; a walker live at the budget's
    end took the whole budget)."""
    P, dev = buf.shape[0], buf.device
    b = torch.cat([buf.to(torch.int64),
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    w16 = (b[:-1] << 8) | b[1:]
    limit = 8 * n_bytes
    pos = torch.arange(P, dtype=torch.int64, device=dev) * 8
    widx = torch.zeros_like(pos)
    units = torch.zeros_like(pos)
    live = torch.ones(P, dtype=torch.bool, device=dev)
    for _ in range(L + L // 15 + 2):
        if not bool(live.any()):
            break
        units += live
        h = (w16[(pos >> 3).clamp(max=P - 1)] >> (8 - (pos & 7))) & 0xFF
        run, size = h >> 4, h & 0xF
        code, chain = size != 0, h == 0xF0
        settle = ((pos + 8 > limit) | (~code & ~chain)
                  | (code & ((pos + 8 + size > limit) | (widx + run >= L))))
        live = live & ~settle
        pos = torch.where(live, pos + torch.where(code, 8 + size, 8), pos)
        widx = torch.where(live, widx + torch.where(code, run + 1, 15), widx)
    return units


def warp_max_units(units) -> int:
    """Sum over warps of the slowest lane's units with one walker per
    thread and byte, as K6 ran before its lanes were refilled (warp w
    walks bytes [32w, 32w + 32))."""
    pad = torch.zeros(-(-units.shape[0] // 32) * 32, dtype=torch.int64,
                      device=units.device)
    pad[:units.shape[0]] = units
    return int(pad.reshape(-1, 32).max(1).values.sum())


def refill_rounds(units, tile: int, threads: int, per_round: int):
    """Rounds of csrc/scan_walk.cu's walker loop each warp runs, modelled
    on these walks: at the top of a round a warp's idle lanes take its
    claimed bytes in lane order, and the warp claims the tile's next 32
    when they run out (warps in order; the card orders them as they come);
    a walk of u units holds its lane for ceil(u / per_round) rounds, and a
    warp runs a round while any lane of it walks.  Returns (blocks *
    threads / 32,) int64."""
    P, dev = units.shape[0], units.device
    n_tiles, warps = -(-(P + 2) // tile), threads // 32
    work = torch.zeros(n_tiles * tile, dtype=torch.int64, device=dev)
    work[:P] = -(-units // per_round)
    work = work.reshape(n_tiles, 1, tile).expand(n_tiles, warps, tile)
    todo = (P - torch.arange(n_tiles, device=dev) * tile).clamp(
        0, tile)[:, None, None]
    i64 = dict(dtype=torch.int64, device=dev)
    left = torch.zeros((n_tiles, warps, 32), **i64)
    more = torch.ones((n_tiles, warps, 32), dtype=torch.bool, device=dev)
    chunk = torch.zeros((n_tiles, warps), **i64)
    used = torch.full((n_tiles, warps), 32, **i64)
    cursor = torch.zeros((n_tiles, 1), **i64)
    rounds = torch.zeros((n_tiles, warps), **i64)
    while True:
        idle = (left == 0) & more
        rank = torch.cumsum(idle, 2) - idle.to(torch.int64)
        n_idle = idle.sum(2)
        take = torch.minimum(n_idle, 32 - used)
        need = n_idle > take
        fresh = cursor + 32 * (torch.cumsum(need, 1) - need.to(torch.int64))
        cursor = cursor + 32 * need.sum(1, keepdim=True)
        q = torch.where(rank < take[..., None],
                        (chunk + used)[..., None] + rank,
                        fresh[..., None] + rank - take[..., None])
        chunk = torch.where(need, fresh, chunk)
        used = torch.where(need, n_idle - take, used + take)
        got = idle & (q < todo)
        left = torch.where(got, work.gather(2, q.clamp(max=tile - 1)), left)
        more = more & (got | ~idle)
        busy = (left > 0).any(2)
        if not bool(busy.any()):
            return rounds.reshape(-1)
        rounds += busy
        left = (left - 1).clamp(min=0)


def time_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def median_call_ms(fn, reps: int) -> float:
    """Median CUDA-event time of single host calls that end in a sync."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def median_host_ms(fn, reps: int) -> float:
    """Median host-clock time of calls whose results are on the host."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def graph_ms(fn, calls: int = 20, reps: int = 10):
    """The device time of one call of ``fn``, without the host work around
    its launches: ``calls`` calls captured in one CUDA graph, replayed
    ``reps`` times (CUDA events).  None, with the reason logged, where the
    capture fails."""
    try:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        ms = time_ms(graph.replay, reps) / calls
        del graph
        return ms
    except RuntimeError as e:
        log(f"  (graph capture failed: {e}; device time not measured)")
        return None


def outputs_equal(a, b) -> bool:
    """Bit-equal tensors, or tuples of them."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


def host_us(fn, calls: int = 2000) -> float:
    """Median host time of one call of ``fn`` in us (``perf_counter``),
    the device queue drained every 100 calls so that no call waits on it.
    """
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 100 == 99:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def device_events(fn) -> dict:
    """The device work one call of ``fn`` runs, from torch.profiler's CUDA
    events (not its ``key_averages()``, which counts device time twice):
    {name: (summed us, count)}, memsets included."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    agg = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us, n = agg.get(ev.name, (0.0, 0))
            agg[ev.name] = (us + ev.time_range.elapsed_us(), n + 1)
    return agg


def device_kernels(fn, top: int = 6, agg=None):
    """The device kernels one call of ``fn`` runs (:func:`device_events`,
    or ``agg`` when given): (their number, their summed time in us, a line
    naming the ``top`` longest)."""
    if agg is None:
        agg = device_events(fn)
    total = sum(us for us, _ in agg.values())
    count = sum(n for _, n in agg.values())
    head = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return count, total, (
        f"{count} kernels, {total:.1f} us on the device: " + "; ".join(
            f"{name[:48]} x{n} {us:.1f} us" for name, (us, n) in head))


def bound(nbytes: float, flops: float = 0.0, rate: float = F32_FLOP_PER_S):
    """(ms, side): the least time the card could take to move ``nbytes``
    (each input read once, each output written once) and do ``flops``
    operations at ``rate`` per second, and which of the two sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_diff(a, b) -> int:
    """Largest elementwise |a - b| of two integer tensors, as an int (0
    for empty ones)."""
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max()) if d.numel() else 0


def k4_against_exact(K, full_f32_matmul, lv, op_t, deq, chunk: int = 2048,
                     bs: int = 1):
    """K4 (``decode_blocks``) and its plain version on (N, K) levels against
    the exact sums of their f32 inputs (f64 on the card): each must equal
    the exact sums' rounding except by 1 where the exact sum lies within
    (K + 16) 2**-23 sum|terms| of a .5 tie, and the two likewise each other;
    at ``bs`` > 1 every pixel's bs x bs replicas must equal it.  Returns
    max |K4 - plain|, the flips against the plain version and the exact
    rounding, the tie positions, and the largest error before the rounding
    of K4's sums (``decode_blocks_sums``) and of the plain version's
    full-f32 product, in units of 2**-23 sum|terms|; and K4's pixels, one
    a replica set."""
    got = K.decode_blocks(lv, op_t, deq, bs=bs)
    plain = K.decode_blocks_plain(lv, op_t, deq, bs=bs)
    if bs > 1:
        n, M = lv.shape[0], op_t.shape[1]
        d = int(round(M ** 0.5))
        got_d = got.view(n, d, bs, d, bs)[:, :, 0, :, 0].reshape(n, M)
        if not (torch.equal(got, K.inflate_blocks(got_d, bs)) and torch.equal(
                plain, K.inflate_blocks(plain.view(n, d, bs, d, bs)[
                    :, :, 0, :, 0].reshape(n, M), bs))):
            raise AssertionError(f"K4 at bs {bs}: a pixel's replicas differ")
        got = got_d
        plain = plain.view(n, d, bs, d, bs)[:, :, 0, :, 0].reshape(n, M)
    sums = K.decode_blocks_sums(lv, op_t, deq)
    op64 = op_t.double()
    aop = op64.abs()
    tol = (lv.shape[1] + 16) * EPS32
    out = dict(err=max_diff(got, plain), flips_plain=0, flips_exact=0,
               ties=0, margin=0.0, margin_plain=0.0)
    for i in range(0, lv.shape[0], chunk):
        a32 = (lv[i:i + chunk] * deq).to(torch.float32)
        a64 = a32.double()
        v = a64 @ op64
        terms = a64.abs() @ aop
        ties = (v - v.floor() - 0.5).abs() <= tol * terms
        ref = torch.round(v).clamp(0, 255)
        g, p = got[i:i + chunk].double(), plain[i:i + chunk].double()
        for x, y, what in ((g, ref, "K4 vs exact"), (p, ref, "plain vs exact"),
                           (g, p, "K4 vs plain")):
            d = (x - y).abs()
            if bool(((d > 0) & ~ties).any()) or bool((d > 1).any()):
                raise AssertionError(f"tie contract violated, {what}: "
                                     f"{int(((d > 0) & ~ties).sum())} "
                                     "non-tie flips")
        out["flips_plain"] += int((g != p).sum())
        out["flips_exact"] += int((g != ref).sum())
        out["ties"] += int(ties.sum())
        with full_f32_matmul():
            mm = torch.matmul(a32, op_t)
        pos = terms > 0
        if bool(pos.any()):
            scale = terms[pos] * EPS32
            out["margin"] = max(out["margin"], float(
                ((sums[i:i + chunk].double() - v).abs()[pos] / scale).max()))
            out["margin_plain"] = max(out["margin_plain"], float(
                ((mm.double() - v).abs()[pos] / scale).max()))
    return out, got


def nvidia_smi(query: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


# ---------------------------------------------------------------------------
# Phase 4f: the parallel layer, the CLI and the profiling module
# ---------------------------------------------------------------------------

BATCH_SEEDS = 8      # the 2048x2048 batch: bench.py's generator, seeds 0-7
SET_4K = 4           # BASELINE config 5's 4K image set (seeds 0-3)
BAND_SHARES = 4      # the 1 x 4 band mesh: one GPU repeated four times
GLOO_PROCS = 2
GLOO_TIMEOUT_S = 300
CLI_TIMEOUT_S = 600
GPU_TESTS_TIMEOUT_S = 300


def qconfig(h: int, w: int, bs: int = 2, d: int = 8,
            q=("qtable", {})):
    from jpeg_tpu_torch import Configuration, QuantizationMethod
    return Configuration(width=w, height=h, block_size=bs, dct_size=d,
                         quantization=QuantizationMethod(q[0], **q[1]))


def run_group(argvs, timeout: float):
    """Start one process per argv in the repository; wait for all with a
    deadline, killing every one of them once one fails or the deadline
    passes.  Returns (return codes, outputs)."""
    procs = [subprocess.Popen(a, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a in argvs]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        outs = [p.communicate(timeout=30)[0] for p in procs]
    return [p.returncode for p in procs], outs


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def gloo_child(port: int, nproc: int, pid: int, outdir: str) -> int:
    """One process of phase 4f's gloo group (``chip_smoke.py --gloo-child
    PORT NPROC PID OUTDIR``): the 4K Y plane's rows of this process
    through ``compress_plane_distributed`` and
    ``decompress_plane_distributed``, then ``compress_batch_distributed``
    over four 2048x2048 images, all on the card's GPU."""
    sys.path.insert(0, REPO)
    from jpeg_tpu_torch.parallel import multihost
    torch.cuda.set_device(0)
    multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    try:
        h, w = SIZES[1]
        cfg = qconfig(h, w)
        _, _, y0, y1 = multihost.host_rows(cfg)
        plane = synth_image(h, w)[y0:y1, :, 0]
        stream = multihost.compress_plane_distributed(plane, cfg)
        with open(os.path.join(outdir, f"stream_{pid}.bin"), "wb") as f:
            f.write(stream)
        np.save(os.path.join(outdir, f"rows_{pid}.npy"),
                multihost.decompress_plane_distributed(stream, cfg))
        bh, bw = SIZES[0]
        blobs, manifest = multihost.compress_batch_distributed(
            [lambda s=s: synth_image(bh, bw, seed=s) for s in range(4)],
            qconfig(bh, bw), verify=True)
        np.save(os.path.join(outdir, f"manifest_{pid}.npy"), manifest)
        for i, blob in enumerate(blobs):
            if blob is not None:
                with open(os.path.join(outdir, f"batch_{i}.bin"), "wb") as f:
                    f.write(blob)
    finally:
        multihost.shutdown()
    return 0


def staged_call(module, steps: dict, fn):
    """Run ``fn`` once with ``module``'s functions named in ``steps``
    timed as ``StageTimer`` stages (each ended by a sync of the CUDA
    tensors it returns).  Returns (timer, whole call ms, fn's result)."""
    from jpeg_tpu_torch.utils.profiling import StageTimer
    st = StageTimer()
    saved = {n: getattr(module, n) for n in steps}

    def timed(name, f):
        def run(*a):
            with st.stage(name) as scope:
                return scope.fence(f(*a))
        return run

    for n, stage_name in steps.items():
        setattr(module, n, timed(stage_name, saved[n]))
    try:
        t0 = time.perf_counter()
        out = fn()
        whole = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in saved.items():
            setattr(module, n, f)
    return st, whole, out


def parallel_phase(dev: torch.device, card: str) -> dict:
    """Phase 4f (see the module docstring).  Returns the launch counts of
    the 1 x 1 mesh's main-path ``compress_batch`` (K1, K2) and
    ``decompress_batch`` (K3, K4) runs."""
    import shutil
    from jpeg_tpu_torch import (compress_band, compress_many, compress_ycbcr,
                                decompress_band, decompress_many,
                                decompress_to_ycbcr, parallel)
    from jpeg_tpu_torch.ops import kernels as K
    from jpeg_tpu_torch.parallel import sharded

    def k_counts(*names):
        c = K.launch_counts()
        return tuple(c[n] for n in names)

    h, w = SIZES[0]
    batch = np.stack([synth_image(h, w, seed=s) for s in range(BATCH_SEEDS)])
    mesh1 = parallel.make_mesh(n_devices=1)
    check(mesh1.devices.shape == (1, 1) and mesh1.devices[0, 0] == dev,
          f"make_mesh(n_devices=1) is the 1 x 1 card mesh: {mesh1}")
    batch_launches = {}
    refs = {}
    for label, cfg in (("main path (bs 2)", qconfig(h, w)),
                       ("CLI defaults (bs 4)", qconfig(h, w, bs=4))):
        ref = [compress_ycbcr(im, cfg) for im in batch]
        refs[cfg.block_size] = ref
        for de in (True, False):
            K.reset_launch_counts()
            blobs = parallel.compress_batch(batch, cfg, mesh1,
                                            device_entropy=de)
            k1, k2 = k_counts("encode_stream_rows", "deposit_rows")
            check(blobs == ref and (k1, k2) == ((1, 1) if de else (0, 0)),
                  f"{label}, {BATCH_SEEDS} x {h}x{w}, 1 x 1 mesh, "
                  f"device_entropy={de}: compress_batch equals compress_ycbcr "
                  f"per image; K1 {k1}, K2 {k2} launches (one each per "
                  "device share with device entropy)")
            if de and cfg.block_size == 2:
                batch_launches.update(encode_stream_rows=k1,
                                      deposit_rows=k2)
        want = [decompress_to_ycbcr(b) for b in ref]
        for de in (True, False):
            K.reset_launch_counts()
            rec = parallel.decompress_batch(ref, mesh1, device_entropy=de)
            k3, k4 = k_counts("decode_stream_blocks", "decode_blocks")
            check(rec.shape == batch.shape and rec.dtype == np.uint8
                  and all(np.array_equal(r, x) for r, x in zip(rec, want))
                  and (k3, k4) == ((1 if de else 0), 1),
                  f"{label}: decompress_batch (device_entropy={de}) equals "
                  f"decompress_to_ycbcr per image; K3 {k3}, K4 {k4} launches")
            if de and cfg.block_size == 2:
                batch_launches.update(decode_stream_blocks=k3,
                                      decode_blocks=k4)
    check(all(batch_launches[n] > 0 for n in MAIN_PATH),
          f"the batch path launched every kernel of its path: "
          f"{batch_launches}")

    log(f"  -- a 1 x {BAND_SHARES} band mesh of {dev} repeated")
    mesh4 = parallel.make_mesh(devices=[dev] * BAND_SHARES, data=1,
                               band=BAND_SHARES)
    cfg = qconfig(h, w)
    shares = sharded.batch_shares(mesh4, cfg, BATCH_SEEDS)
    K.reset_launch_counts()
    blobs = parallel.compress_batch(batch, cfg, mesh4)
    k1, k2 = k_counts("encode_stream_rows", "deposit_rows")
    K.reset_launch_counts()
    rec = parallel.decompress_batch(blobs, mesh4)
    k3, k4 = k_counts("decode_stream_blocks", "decode_blocks")
    check(blobs == refs[2] and len(shares) == BAND_SHARES
          and (k1, k2, k3, k4) == (BAND_SHARES,) * 4
          and all(np.array_equal(r, decompress_to_ycbcr(b))
                  for r, b in zip(rec, blobs)),
          f"{BATCH_SEEDS} x {h}x{w} on {len(shares)} row-band shares: "
          "compress_batch / decompress_batch equal the per-image calls; "
          f"K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4} launches (one each a share)")
    H4, W4 = SIZES[1]
    set4k = np.stack([synth_image(H4, W4, seed=s) for s in range(SET_4K)])
    cfg = qconfig(H4, W4)
    shares = sharded.batch_shares(mesh4, cfg, SET_4K)
    K.reset_launch_counts()
    blobs = parallel.compress_batch(set4k, cfg, mesh4)
    k1, k2 = k_counts("encode_stream_rows", "deposit_rows")
    check(blobs == [compress_ycbcr(im, cfg) for im in set4k]
          and (k1, k2) == (len(shares),) * 2
          and all(np.array_equal(r, decompress_to_ycbcr(b)) for r, b in
                  zip(parallel.decompress_batch(blobs, mesh4), blobs)),
          f"{SET_4K} x {H4}x{W4} (BASELINE config 5's set): compress_batch "
          f"and decompress_batch equal the per-image calls on "
          f"{len(shares)} share(s) ({cfg.blocks_high} block rows over "
          f"{BAND_SHARES}: an indivisible axis stays whole); K1 {k1}, K2 "
          f"{k2}")
    for label, cfg in (
            ("main path", qconfig(H4, W4)),
            ("(2) bs 5", qconfig(H4, W4, bs=5)),
            ("(3) bs 4, d 24, divide 1000",
             qconfig(H4, W4, bs=4, d=24, q=("divide", {"divisor": 1000})))):
        n_sh = len(sharded.row_shares(mesh4, cfg))
        for b, name in enumerate("Y Cb Cr".split()):
            plane = set4k[0, :, :, b]
            serial = compress_band(plane, cfg)
            host = parallel.compress_plane(plane, cfg, mesh4)
            K.reset_launch_counts()
            devs = parallel.compress_plane_device_entropy(plane, cfg, mesh4)
            k1, k2 = k_counts("encode_stream_rows", "deposit_rows")
            K.reset_launch_counts()
            rec = parallel.decompress_plane(serial, cfg, mesh4)
            k3, k4 = k_counts("decode_stream_blocks", "decode_blocks")
            check(host == serial and devs == serial
                  and np.array_equal(rec, decompress_band(serial, cfg))
                  and (k1, k2, k3, k4) == (n_sh,) * 4,
                  f"{H4}x{W4} {label}, {name}: compress_plane and "
                  "compress_plane_device_entropy equal compress_band byte "
                  "for byte, decompress_plane equals decompress_band, on "
                  f"{n_sh} row-band shares ({cfg.blocks_high} block rows); "
                  f"K1 {k1}, K2 {k2}, K3 {k3}, K4 {k4}")

    log(f"  -- {GLOO_PROCS} processes on {dev} over gloo")
    outdir = os.path.join(REPO, "build", "gloo")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    port = free_port()
    t0 = time.perf_counter()
    rcs, outs = run_group([[sys.executable, os.path.abspath(__file__),
                            "--gloo-child", str(port), str(GLOO_PROCS),
                            str(p), outdir] for p in range(GLOO_PROCS)],
                          GLOO_TIMEOUT_S)
    for p, (rc, out) in enumerate(zip(rcs, outs)):
        if rc != 0:
            log(out)
        check(rc == 0, f"gloo process {p} exited {rc}")
    log(f"  the group ran {time.perf_counter() - t0:.1f} s (host clock)")
    cfg = qconfig(H4, W4)
    y_plane = synth_image(H4, W4)[:, :, 0]
    serial = compress_band(y_plane, cfg)
    streams = [open(os.path.join(outdir, f"stream_{p}.bin"), "rb").read()
               for p in range(GLOO_PROCS)]
    check(all(s == serial for s in streams),
          f"compress_plane_distributed: every process holds the serial "
          f"{H4}x{W4} Y stream ({len(serial)} bytes)")
    rows = [np.load(os.path.join(outdir, f"rows_{p}.npy"))
            for p in range(GLOO_PROCS)]
    check(np.array_equal(np.concatenate(rows), decompress_band(serial, cfg)),
          "decompress_plane_distributed: the processes' rows ("
          + ", ".join(str(r.shape[0]) for r in rows)
          + ") reassemble the serial plane")
    manifests = [np.load(os.path.join(outdir, f"manifest_{p}.npy"))
                 for p in range(GLOO_PROCS)]
    bcfg = qconfig(h, w)
    check(all(np.array_equal(m, manifests[0]) for m in manifests)
          and all(open(os.path.join(outdir, f"batch_{i}.bin"), "rb").read()
                  == refs[2][i] for i in range(4))
          and list(manifests[0][:, 0]) == [len(b) for b in refs[2][:4]]
          and (manifests[0][:, 2] > 1000 * PSNR_MIN_DB).all(),
          f"compress_batch_distributed: the manifest is identical on every "
          f"process ({manifests[0].tolist()}), each blob equals "
          "compress_ycbcr's, PSNR > 30 dB")

    log("  -- the CLI")
    try:
        from PIL import Image
        pil = True
    except ImportError as e:
        pil = False
        log(f"  python -m jpeg_tpu_torch batch: not run, Pillow does not "
            f"import here ({e}); the batch functions it calls ran above")
    if pil:
        cli = os.path.join(REPO, "build", "cli")
        shutil.rmtree(cli, ignore_errors=True)
        dirs = {k: os.path.join(cli, k) for k in ("png", "jc", "rec")}
        os.makedirs(dirs["png"])
        for i, im in enumerate(batch):
            Image.fromarray(im, "YCbCr").convert("RGB").save(
                os.path.join(dirs["png"], f"img{i}.png"), compress_level=1)
        lines = {}
        for mode, src, dst, flags in (
                ("encode", "png", "jc", ["--block_size", "2", "--mesh",
                                         "--verify"]),
                ("decode", "jc", "rec", ["--decompress"])):
            argv = [sys.executable, "-m", "jpeg_tpu_torch", "batch",
                    dirs[src], dirs[dst], *flags]
            (rc,), (out,) = run_group([argv], CLI_TIMEOUT_S)
            if rc != 0:
                log(out)
            check(rc == 0, f"{' '.join(argv[1:4])} ... {' '.join(flags)} "
                  f"exited {rc}")
            lines[mode] = json.loads(out.strip().splitlines()[-1])
            log(f"  {mode}: {json.dumps(lines[mode])}  [{card}]")
        same = all(
            open(os.path.join(dirs["jc"], f"img{i}.jc"), "rb").read()
            == compress_ycbcr(np.asarray(Image.open(os.path.join(
                dirs["png"], f"img{i}.png")).convert("YCbCr")), bcfg)
            for i in range(BATCH_SEEDS))
        check(same and lines["encode"]["images"] == BATCH_SEEDS
              and lines["encode"]["failures"] == 0
              and lines["encode"]["mean_psnr_db"] > PSNR_MIN_DB
              and lines["decode"]["images"] == BATCH_SEEDS
              and lines["decode"]["failures"] == 0,
              f"python -m jpeg_tpu_torch batch --mesh --verify: "
              f"{BATCH_SEEDS} containers byte-equal to compress_ycbcr's, "
              f"mean PSNR {lines['encode']['mean_psnr_db']} dB > "
              f"{PSNR_MIN_DB}; --decompress decoded them all")

    log(f"  -- timing ({BATCH_SEEDS} x {h}x{w}, main path, 1 x 1 mesh; "
        f"host clock, median of 3)")
    cfg, ref = qconfig(h, w), refs[2]
    mp = BATCH_SEEDS * h * w / 1e6
    listed = list(batch)
    for label, fn in (
            ("compress_batch", lambda: parallel.compress_batch(batch, cfg,
                                                               mesh1)),
            ("compress_many (depth 2)", lambda: compress_many(listed, cfg)),
            ("compress_ycbcr loop", lambda: [compress_ycbcr(im, cfg)
                                             for im in listed]),
            ("decompress_batch", lambda: parallel.decompress_batch(ref,
                                                                   mesh1)),
            ("decompress_many (depth 2)", lambda: decompress_many(ref)),
            ("decompress_to_ycbcr loop", lambda: [decompress_to_ycbcr(b)
                                                  for b in ref])):
        ms = median_host_ms(fn, 3)
        log(f"  {label}: {ms:.3f} ms = {mp / ms * 1e3:.1f} MP/s  [{card}]")
    for label, steps, fn in (
            ("compress_batch", {
                "_share_levels": "upload + transform",
                "_device_entropy": "stats pull + K1 + K2 + stream pull"},
             lambda: parallel.compress_batch(batch, cfg, mesh1)),
            ("decompress_batch", {
                "_scan_streams": "host C++ scans (thread pool)",
                "_parse_shares": "slices + upload + K3",
                "_decode_share_planes": "K4 + layout (BandDecoder)",
                "_pull_planes": "plane pull + assembly"},
             lambda: parallel.decompress_batch(ref, mesh1))):
        st, whole, out = staged_call(sharded, steps, fn)
        same = (out == ref if label == "compress_batch" else
                all(np.array_equal(r, decompress_to_ycbcr(b))
                    for r, b in zip(out, ref)))
        check(same, f"the StageTimer run of {label} gives the per-image "
              "results")
        log(f"  StageTimer, one {label} call: {whole:.3f} ms in all, "
            f"{whole - 1e3 * sum(st.totals.values()):.3f} ms outside the "
            f"stages  [{card}]\n" + str(st))
    return batch_launches


def gpu_tests_phase(card: str) -> None:
    """Phase 4g (see the module docstring): ``gpu_tests/`` in a
    subprocess; fails unless every collected case passed."""
    import xml.etree.ElementTree as ET
    report = os.path.join(REPO, "build", "gpu_tests.xml")
    if os.path.exists(report):
        os.remove(report)
    argv = [sys.executable, "-m", "pytest", "gpu_tests", "-q", "-o",
            "addopts=", "-p", "no:cacheprovider", f"--junitxml={report}"]
    t0 = time.perf_counter()
    (rc,), (out,) = run_group([argv], GPU_TESTS_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    tests = passed = 0
    if os.path.exists(report):
        root = ET.parse(report).getroot()
        suite = root if root.tag == "testsuite" else root.find("testsuite")
        tests = int(suite.get("tests"))
        passed = tests - sum(int(suite.get(k)) for k in
                             ("failures", "errors", "skipped"))
    if rc != 0 or passed != tests:
        log(out)
    log(f"  gpu_tests: {passed} passed of {tests} collected in "
        f"{seconds:.1f} s  [{card}]")
    check(rc == 0 and tests > 0 and passed == tests,
          f"python -m pytest gpu_tests exited {rc}: {passed} of {tests} "
          "collected cases passed (none skipped)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # The host-free decode's scan_offsets_hybrid warns and returns the host
    # scanner's starts when the device scan rejects a stream the host
    # accepts: here that is a failure of K6-K8, not a fallback.
    warnings.filterwarnings("error", message="device scan rejected",
                            category=RuntimeWarning)
    try:
        import jpeg_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        print(f"chip_smoke: {e}: run it from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 1
    from jpeg_tpu_torch import (BadRleCodeError, BadStreamError,
                                Configuration, QuantizationMethod,
                                compress_many, compress_ycbcr, container,
                                decompress_many, decompress_to_device,
                                decompress_to_ycbcr, entropy, psnr)
    from jpeg_tpu_torch.entropy import device_codec as DC
    from jpeg_tpu_torch.entropy import device_scan as DS
    from jpeg_tpu_torch.entropy import native_codec, numpy_codec
    from jpeg_tpu_torch.ops import kernels as K
    from jpeg_tpu_torch.ops.band import BandDecoder, BandEncoder
    from jpeg_tpu_torch.ops import quantize as Q
    from jpeg_tpu_torch.ops import transform as T
    from jpeg_tpu_torch.ops.blocks import blockify, crop, deblockify
    from jpeg_tpu_torch.utils import parity
    from jpeg_tpu_torch.utils.device import full_f32_matmul

    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    log(f"== phase 1: device\n  nvidia-smi: {card}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    log("== phase 2: build")
    t0 = time.perf_counter()
    so = K.build()
    K._library()
    log(f"  built {os.path.relpath(so)} in {time.perf_counter() - t0:.1f} s")
    with open(os.path.join(os.path.dirname(so), "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())
    check(native_codec.available(), "host C++ entropy codec built")

    def cfg_for(h, w):
        return Configuration(width=w, height=h, block_size=2, dct_size=8,
                             quantization=QuantizationMethod("qtable"))

    log("== phase 3: kernels vs plain versions at the main path's shapes")
    h, w = SIZES[0]
    cfg = cfg_for(h, w)
    img = synth_image(h, w)
    img_t = torch.from_numpy(img).to(dev).permute(2, 0, 1)
    flat = BandEncoder(cfg).to(dev)(img_t).reshape(-1, 64)     # (3N, L)
    L = flat.shape[1]
    n_blocks = flat.shape[0]
    log(f"  levels: {tuple(flat.shape)} from a {h}x{w} image")

    def entropy_kernels(label, lv):
        """K1-K3 and K9 vs their plain versions (bit-equal) and the host
        codec, K9's rows also vs K1's; returns the timing closures on these
        inputs."""
        W = -(-int(DC.block_bytes_of(lv).max()) // 4)
        rows_k, bb_k = K.encode_stream_rows(lv, W)
        rows_p, bb_p = K.encode_stream_rows_plain(lv, W)
        check(torch.equal(rows_k, rows_p) and torch.equal(bb_k, bb_p),
              f"K1 {label}: rows and block bytes bit-equal (W={W})")
        cbits, vhi, vlo, bb_t = DC._unit_groups(lv)
        rows9_k = K.encode_stream_rows_tables(cbits, vhi, vlo, W)
        rows9_p = K.encode_stream_rows_tables_plain(cbits, vhi, vlo, W)
        check(torch.equal(rows9_k, rows9_p) and torch.equal(rows9_k, rows_k)
              and torch.equal(bb_t, bb_k),
              f"K9 {label}: rows bit-equal to plain and to K1's, "
              "_unit_groups' block bytes to K1's")
        n, L1 = cbits.shape
        total = int(bb_k.to(torch.int64).sum())
        buf_k = K.deposit_rows(rows_k, bb_k, total)
        buf_p = K.deposit_rows_plain(rows_p, bb_p, total)
        check(torch.equal(buf_k, buf_p), f"K2 {label}: stream bit-equal "
              f"({total} bytes)")
        want = native_codec.encode_levels(lv.cpu().numpy())
        check(buf_k.cpu().numpy().tobytes() == want,
              f"K1+K2 {label}: stream equals the host C++ encoder's")
        starts = torch.cumsum(bb_k.to(torch.int64), 0) - bb_k.to(torch.int64)
        dec_k = K.decode_stream_blocks(buf_k, starts, L)
        dec_p = K.decode_stream_blocks_plain(buf_k, starts, L)
        check(torch.equal(dec_k, dec_p) and torch.equal(dec_k, lv),
              f"K3 {label}: levels bit-equal to plain and to the input")
        return buf_k, bb_k, {
            "encode_stream_rows": dict(
                err=max(max_diff(rows_k, rows_p), max_diff(bb_k, bb_p)),
                fn=lambda: K.encode_stream_rows(lv, W),
                plain=lambda: K.encode_stream_rows_plain(lv, W),
                nbytes=4 * n * (L + W + 1)),
            "encode_stream_rows_tables": dict(
                err=max_diff(rows9_k, rows9_p),
                fn=lambda: K.encode_stream_rows_tables(cbits, vhi, vlo, W),
                plain=lambda: K.encode_stream_rows_tables_plain(
                    cbits, vhi, vlo, W),
                plain_reps=50,
                # cbits in full; vlo only at coded slots and vhi only at
                # groups past 32 bits (the kernel loads no more); the rows
                nbytes=4 * (n * L1 + int((cbits > 0).sum())
                            + int((cbits > 32).sum()) + n * W)),
            "deposit_rows": dict(
                err=max_diff(buf_k, buf_p),
                fn=lambda: K.deposit_rows(rows_k, bb_k, total),
                plain=lambda: K.deposit_rows_plain(rows_k, bb_k, total),
                # the block bytes, then each block's bytes of its row read
                # and written once (the rows' zero padding is not needed)
                nbytes=4 * n + 2 * total),
            "decode_stream_blocks": dict(
                err=max_diff(dec_k, dec_p),
                fn=lambda: K.decode_stream_blocks(buf_k, starts, L),
                plain=lambda: K.decode_stream_blocks_plain(buf_k, starts, L),
                nbytes=total + 8 * n + 4 * n * L),
            "_unit_groups": dict(fn=lambda: DC._unit_groups(lv)),
        }

    img_buf, img_bb, results = entropy_kernels("image", flat)
    unit_groups_fn = results.pop("_unit_groups")["fn"]
    adv_buf, adv_bb, _ = entropy_kernels(
        "adversarial",
        torch.from_numpy(adversarial_levels(n_blocks, L)).to(dev))

    # K2 at its design's edges (tiles of K.DEPOSIT_TILE_BLOCKS blocks, words
    # assembled across blocks, edge bytes, the zero tail): bit-equal to the
    # plain version, and where the rows are K1's at a cap of the stream's
    # length, to the host C++ encoder's stream.
    def k2_edge(label, lv=None, rows=None, bb=None, caps=(0,)):
        if lv is not None:
            W_e = -(-int(DC.block_bytes_of(lv).max()) // 4)
            rows, bb = K.encode_stream_rows(lv, W_e)
            host = native_codec.encode_levels(lv.cpu().numpy())
        total_e = int(bb.to(torch.int64).sum())
        for dc in caps:
            cap_e = max(total_e + dc, 0)
            got = K.deposit_rows(rows, bb, cap_e)
            ok = torch.equal(got, K.deposit_rows_plain(rows, bb, cap_e))
            if lv is not None and cap_e == total_e:
                ok = ok and got.cpu().numpy().tobytes() == host
            check(ok, f"K2 {label} (N = {rows.shape[0]}, W = {rows.shape[1]}"
                  f", cap = total {dc:+d} = {cap_e}): bit-equal to plain"
                  + (" and the host C++ stream" if lv is not None
                     and cap_e == total_e else ""))

    rng_k2 = np.random.default_rng(17)
    k2_edge("all 1-byte (EOB-only) blocks",
            lv=torch.zeros((n_blocks, L), dtype=torch.int32, device=dev),
            caps=(0, -1, -3, 1, 4))
    k2_edge("one block", lv=torch.from_numpy(
        adversarial_levels(6, L, seed=5)[1:2]).to(dev), caps=(0, -1, 3))
    k2_edge(f"N = {n_blocks + 1}, not a multiple of the tile",
            lv=torch.from_numpy(adversarial_levels(n_blocks + 1, L,
                                                   seed=6)).to(dev),
            caps=(0, -5, -(n_blocks // 2), 1, 2, 3, 1001))
    for n_e, W_e in ((K.DEPOSIT_TILE_BLOCKS - 1, 3), (n_blocks + 7, 9)):
        rows_e = torch.from_numpy(rng_k2.integers(
            -2 ** 31, 2 ** 31, (n_e, W_e)).astype(np.int32)).to(dev)
        full = torch.full((n_e,), 4 * W_e, dtype=torch.int32, device=dev)
        k2_edge(f"blocks of exactly 4W = {4 * W_e} bytes", rows=rows_e,
                bb=full, caps=(0, -1, -2, -3, 1, 2, 3))
        mixed = rng_k2.integers(1, 4 * W_e + 1, n_e)
        mixed[rng_k2.random(n_e) < 0.3] = 4 * W_e
        mixed[rng_k2.random(n_e) < 0.3] = 1
        k2_edge("1- to 4W-byte blocks, random rows", rows=rows_e,
                bb=torch.from_numpy(mixed.astype(np.int32)).to(dev),
                caps=(0, -1, -7, 1, 3, 4, 4099))

    # Bound again in scan_kernels' own scope for its timing closures:
    # main() reassigns nb in phase 4.
    band_blocks = n_blocks // 3
    scan_err = dict.fromkeys(
        HOST_FREE_PATH + ("scan_walk_capped", "scan_walk_resume"), 0)

    def band_ends(bb) -> list:
        return np.cumsum(bb.to(torch.int64).reshape(3, -1).sum(1).cpu()
                         .numpy()).tolist()

    def host_starts(raw: bytes, ends: list, Lh=L, nb=band_blocks):
        """The host C++ scanner's starts of each band, or None where it
        rejects one."""
        out, s0 = [], 0
        for e in ends:
            try:
                out.append(native_codec.scan_offsets(raw[s0:e], nb, Lh)
                           + s0)
            except (BadStreamError, BadRleCodeError):
                return None
            s0 = e
        return np.concatenate(out)

    def two_sweep_caps(L_c):
        b = K._walk_units(L_c)
        return sorted({*K6R_EDGE_CAPS, b - 1, b})

    def scan_kernels(label, buf, ends, quiet=False, L=L, nb=band_blocks,
                     k10_plain=False):
        """K6-K8 vs their plain versions (bit-equal) on one buffer of three
        bands of nb blocks, the two-sweep end table (K6' twice, at every cap
        of ``two_sweep_caps``) vs the single sweep (bit-equal), and the
        starts vs the host C++ scanner's.  K10 gives K8's check, and K8's
        starts where it holds; with ``k10_plain`` also its plain version's
        starts and status, bit for bit.  Returns the device check and the
        timing closures on these inputs."""
        n = buf.shape[0]
        s0s_l = [0] + ends[:-1]
        targets = torch.tensor(ends, dtype=torch.int64, device=dev)
        s0s = torch.tensor(s0s_l, dtype=torch.int64, device=dev)
        E_k = K.scan_walk(buf, n, L)
        E_p = K.scan_walk_plain(buf, n, L)
        err_2 = max(max_diff(DS.end_table(buf, n, L, cap=c), E_k)
                    for c in two_sweep_caps(L))
        st_k, ok_k = K.chase_starts_multi(E_k, targets, s0s, nb)
        st_p, ok_p = K.chase_starts_multi_plain(E_k, targets, s0s, nb)
        one_k = [K.chase_starts(E_k, t, s0, nb) for t, s0 in zip(ends, s0s_l)]
        st_10, status_10 = K.segment_scan(buf, s0s_l, ends, nb, L)
        err_10 = 0
        if k10_plain:
            st_10p, status_10p = K.segment_scan_plain(
                buf, s0s_l, ends, nb, L, K.SEGMENT_BYTES)
            err_10 = max(max_diff(st_10, st_10p),
                         max_diff(status_10, status_10p))
        one_p = [K.chase_starts_plain(E_k, t, s0, nb)
                 for t, s0 in zip(ends, s0s_l)]
        errs = {
            "scan_walk": max_diff(E_k, E_p),
            "scan_walk_capped": err_2,
            "scan_walk_resume": err_2,
            "chase_starts_multi": max(max_diff(st_k, st_p),
                                      max_diff(ok_k, ok_p)),
            "chase_starts": max(max(max_diff(a, c), max_diff(b, d))
                                for (a, b), (c, d) in zip(one_k, one_p)),
            "segment_scan": err_10,
        }
        for k, v in errs.items():
            scan_err[k] = max(scan_err[k], v)
        want = host_starts(buf.cpu().numpy().tobytes(), ends, L, nb)
        ok = bool(ok_k.all())
        ok_10 = int(status_10[0]) == 0
        what = (f"K6-K8 {label}: end table, starts and checks bit-equal to "
                f"plain; two-sweep end table (caps {two_sweep_caps(L)}) "
                f"bit-equal; check {ok} "
                f"= host C++ scanner's {want is not None}; starts = host "
                f"starts; K10's check {ok_10} = K8's, its starts K8's where "
                "it holds" + (", starts and status bit-equal to its plain "
                              "version's" if k10_plain else ""))
        good = (not any(errs.values()) and ok == (want is not None)
                and ok_10 == ok
                and (not ok or torch.equal(st_10, st_k.reshape(-1)))
                and [bool(o) for _, o in one_k] == ok_k.tolist()
                and (want is None or np.array_equal(st_k.reshape(-1).cpu()
                                                    .numpy(), want)))
        if quiet:
            if not good:
                raise AssertionError(what)
        else:
            check(good, what)
        # The chase reads one entry of E per start and writes the start:
        # nb of each (a serial chain, which this count does not show).
        return ok, {
            "scan_walk": dict(
                err=errs["scan_walk"], fn=lambda: K.scan_walk(buf, n, L),
                plain=lambda: K.scan_walk_plain(buf, n, L),
                nbytes=n + 4 * (n + 2)),
            "chase_starts": dict(
                err=errs["chase_starts"],
                fn=lambda: K.chase_starts(E_k, ends[0], 0, nb),
                plain=lambda: K.chase_starts_plain(E_k, ends[0], 0, nb),
                nbytes=12 * nb + 1),
            "chase_starts_multi": dict(
                err=errs["chase_starts_multi"],
                fn=lambda: K.chase_starts_multi(E_k, targets, s0s, nb),
                plain=lambda: K.chase_starts_multi_plain(E_k, targets, s0s,
                                                         nb),
                nbytes=len(ends) * (12 * nb + 1)),
            # K10 reads each stream byte and writes each start once.
            "segment_scan": dict(
                err=errs["segment_scan"],
                fn=lambda: K.segment_scan(buf, s0s_l, ends, nb, L),
                plain=lambda: K.segment_scan_plain(buf, s0s_l, ends, nb, L,
                                                   K.SEGMENT_BYTES),
                plain_reps=1, nbytes=n + 8 * len(ends) * nb),
        }

    img_ends = band_ends(img_bb)
    ok, scan_results = scan_kernels("image stream", img_buf, img_ends,
                                    k10_plain=True)
    check(ok, f"K6+K8 accept the image's {img_ends[-1]}-byte stream")
    ok, _ = scan_kernels("adversarial stream", adv_buf, band_ends(adv_bb),
                         k10_plain=True)
    check(ok, "K6+K8 accept the adversarial stream")
    rng = np.random.default_rng(3)
    accepted = 0
    for i in range(MUTANTS):
        mut = img_buf.clone()
        q = int(rng.integers(img_ends[-1]))
        mut[q] = (int(mut[q]) + int(rng.integers(1, 256))) % 256
        ok, _ = scan_kernels(f"mutant {i} (byte {q})", mut, img_ends,
                             quiet=True)
        accepted += ok
    check(True, f"K6-K8 on {MUTANTS} single-byte mutants: bit-equal to plain, "
          f"check = host C++ scanner's ({accepted} accepted by both)")
    garbage = torch.from_numpy(rng.integers(0, 256, 3 << 16, dtype=np.uint8))
    for label, g in (("uniform garbage", garbage),
                     ("0xff garbage", torch.full((12288,), 0xFF,
                                                 dtype=torch.uint8))):
        n = g.shape[0]
        ok, _ = scan_kernels(label, g.to(dev), [n // 3, 2 * n // 3, n])
        check(not ok, f"{label}: rejected")
    raw = img_buf.cpu().numpy().tobytes()
    b0, b1 = img_ends[0], img_ends[1]
    trunc = raw[:b1 - 1] + raw[b1:]
    t_ends = [b0, b1 - 1, img_ends[2] - 1]
    t_buf = torch.frombuffer(bytearray(trunc), dtype=torch.uint8).to(dev)
    ok, _ = scan_kernels("truncated middle band", t_buf, t_ends)
    _, ok_api = DS.scan_bands_starts(t_buf, t_ends, band_blocks, L)
    _, status_api = DS.scan_bands_segmented(t_buf, t_ends, band_blocks, L)
    check(not ok and not bool(ok_api) and not DS.check_held(status_api),
          "truncated middle band: check fails (K6 + K8 and K10)")
    results.update(scan_results)

    # The redesigned kernels at their edges: K7 / K8's two forms, the long
    # one's anchors and fill ranges (jump k), the selection between them,
    # chain starts past P and chains that meet ERR, 1 to 64 chains; K6's
    # tiles, halo and reads past the staged bytes.
    k = K.CHASE_JUMP
    dmax = K.CHASE_DIRECT_MAX

    def forms(P2, B, nb_f):
        """K7 / K8's short and long forms at nb_f, whichever the wrappers
        pick (the kernel takes the short form at nb_f <= k)."""
        a = -(-nb_f // k)
        return (("short", K.ChasePlan(0, 0, 0)),
                ("long", K.ChasePlan(a, P2, B * a)))

    host = host_starts(raw, img_ends)
    host_b = host.reshape(3, band_blocks)
    E_img = K.scan_walk(img_buf, img_ends[-1], L)
    P_img = img_ends[-1]
    err_img = P_img + 1
    s0_img = [int(h[0]) for h in host_b]
    chase_cases = [(f"nb = {nb_e}", E_img, [int(h[nb_e]) for h in host_b],
                    s0_img, nb_e, [True] * 3, [h[:nb_e] for h in host_b])
                   for nb_e in (0, 1, k - 1, k, k + 1, 3 * k + 5, dmax,
                                dmax + 1, dmax + k + 1)]
    chase_cases.append(("chain starts P, P + 1, P + 7 and 2**40 (past the "
                        "table)", E_img, [err_img] * 4,
                        [P_img, P_img + 1, P_img + 7, 1 << 40], 3 * k + 5,
                        [True] * 4, None))
    E_first = E_img.clone()
    E_first[s0_img[1]] = err_img
    chase_cases.append(("band 1 meets ERR at its first step", E_first,
                        img_ends, s0_img, band_blocks, [True, False, True],
                        None))
    E_mid = E_img.clone()
    E_mid[int(host_b[2][band_blocks // 2])] = err_img
    chase_cases.append(("band 2 meets ERR mid-band", E_mid, img_ends, s0_img,
                        band_blocks, [True, True, False], None))
    nb64 = 3 * k + 5
    at64 = [j * (len(host) - nb64) // 64 for j in range(64)]
    all_starts = np.append(host, P_img)
    chase_cases.append((
        "64 chains on one buffer, every other target one byte off", E_img,
        [int(all_starts[i + nb64]) + j % 2 for j, i in enumerate(at64)],
        [int(host[i]) for i in at64], nb64, [j % 2 == 0 for j in range(64)],
        [host[i:i + nb64] if j % 2 == 0 else None
         for j, i in enumerate(at64)]))
    for label, E_c, tg, s0c, nb_c, want_ok, want_st in chase_cases:
        tg_t = torch.tensor(tg, dtype=torch.int64, device=dev)
        s0_t = torch.tensor(s0c, dtype=torch.int64, device=dev)
        st_k, ok_k = K.chase_starts_multi(E_c, tg_t, s0_t, nb_c)
        st_p, ok_p = K.chase_starts_multi_plain(E_c, tg_t, s0_t, nb_c)
        err8 = max(max_diff(st_k, st_p), max_diff(ok_k, ok_p))
        err7 = 0
        for b, (t, s) in enumerate(zip(tg, s0c)):
            a, o = K.chase_starts(E_c, t, s, nb_c)
            err7 = max(err7, max_diff(a, st_p[b]), max_diff(o, ok_p[b]))
        for _, plan in forms(E_c.shape[0], len(tg), nb_c):   # uncounted
            st_f, ok_f = K._chase(E_c, nb_c, tg_t, s0_t, plan)
            err8 = max(err8, max_diff(st_f, st_p), max_diff(ok_f, ok_p))
        for b, (t, s) in enumerate(zip(tg[:3], s0c)):
            for _, plan in forms(E_c.shape[0], 1, nb_c):
                a, o = K._chase(E_c, nb_c, t, s, plan)
                err7 = max(err7, max_diff(a[0], st_p[b]),
                           max_diff(o[0], ok_p[b]))
        scan_err["chase_starts_multi"] = max(scan_err["chase_starts_multi"],
                                             err8)
        scan_err["chase_starts"] = max(scan_err["chase_starts"], err7)
        st_np = st_k.cpu().numpy()
        check(err8 == 0 and err7 == 0 and ok_k.tolist() == want_ok
              and (want_st is None or all(
                  w is None or np.array_equal(st_np[b], w)
                  for b, w in enumerate(want_st))),
              f"K7 / K8 (k = {k}), {label} (B = {len(tg)}, nb = {nb_c}, "
              f"{'short' if K.chase_plan(1, 1, nb_c).anchors == 0 else 'long'}"
              " form): starts and checks bit-equal to plain, in both forms, "
              "K7 band by band too; "
              f"checks {ok_k.tolist() if len(tg) <= 4 else sum(want_ok)}"
              + ("; accepted chains' starts = host C++ starts"
                 if want_st is not None else ""))

    def walk_edge(label, buf, n, L_e, target, nb_e):
        """K6 vs its plain version (bit-equal) on one buffer, and K7's
        starts from byte 0 (nb_e blocks to ``target``) vs the host C++
        scanner's."""
        E_k = K.scan_walk(buf, n, L_e)
        err6 = max_diff(E_k, K.scan_walk_plain(buf, n, L_e))
        scan_err["scan_walk"] = max(scan_err["scan_walk"], err6)
        st, ok7 = K.chase_starts(E_k, target, 0, nb_e)
        want = native_codec.scan_offsets(
            buf[:target].cpu().numpy().tobytes(), nb_e, L_e)
        plan = K.scan_walk_plan(buf.shape[0], L_e, sms)
        check(err6 == 0 and bool(ok7)
              and np.array_equal(st.cpu().numpy(), want),
              f"K6 {label} ({buf.shape[0]}-byte buffer, n_bytes {n}, "
              f"L = {L_e}; tiles of {plan.tile}, halo {plan.halo}): end "
              "table bit-equal to plain; K7's starts = host C++ starts")
        return plan

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng_e = np.random.default_rng(11)
    tail = torch.from_numpy(rng_e.integers(0, 256, 4099, dtype=np.uint8))
    longer = torch.cat([img_buf, tail.to(dev)])
    walk_edge("on a buffer 4,099 garbage bytes longer than n_bytes", longer,
              P_img, L, img_ends[0], band_blocks)
    one = native_codec.encode_levels(adversarial_levels(6, L, seed=5)[1:2])
    one_buf = torch.frombuffer(bytearray(one), dtype=torch.uint8).to(dev)
    walk_edge("on a stream of one block, shorter than a tile", one_buf,
              len(one), L, len(one), 1)
    # The streams K6' is checked on: (buffer, n_bytes, L)
    resume_streams = {
        "image stream": (img_buf, P_img, L),
        "buffer 4,099 garbage bytes longer than its stream": (longer, P_img,
                                                              L),
        f"one-block stream ({len(one)} bytes, below one tile)": (
            one_buf, len(one), L),
        "200-byte prefix of the image stream (below one tile)": (
            img_buf[:200].clone(), 200, L),
        "uniform garbage": (garbage.to(dev), garbage.shape[0], L)}
    lv_ch = np.zeros((3000, 576), np.int32)
    lv_ch[:, 575] = rng_e.integers(1, 300, 3000)
    chains = native_codec.encode_levels(lv_ch)
    ch_buf = torch.frombuffer(bytearray(chains), dtype=torch.uint8).to(dev)
    plan = walk_edge("on 38-byte zero-run chains (L = 576)", ch_buf,
                     len(chains), 576, len(chains), 3000)
    inside = [t for t in range(plan.tile, len(chains), plan.tile)
              if chains[t - 1] == chains[t] == 0xF0]
    check(len(inside) > 0, f"  {len(inside)} of its tile boundaries lie "
          "inside a zero-run chain")
    lv_far = np.where(rng_e.random((60, 1024)) < 0.9, 16383, -1)
    far = native_codec.encode_levels(lv_far.astype(np.int32))
    plan = walk_edge("on 2.9 KB blocks (L = 1024): walks past the halo read "
                     "global memory",
                     torch.frombuffer(bytearray(far), dtype=torch.uint8).to(
                         dev), len(far), 1024, len(far), 60)
    check(K.walk_span_bytes(1024) > plan.halo,
          f"  a walk spans up to {K.walk_span_bytes(1024)} bytes, the halo "
          f"{plan.halo}")
    cfg24 = Configuration(width=w, height=h, block_size=4, dct_size=24,
                          quantization=QuantizationMethod("divide",
                                                          divisor=1000))
    lv24 = BandEncoder(cfg24).to(dev)(img_t).cpu().numpy()
    for label, lvs in ((f"d = 24 stream (BASELINE (3), {h}x{w})", lv24),
                       ("adversarial L = 576 stream",
                        adversarial_levels(3 * 1200, 576, seed=4).reshape(
                            3, 1200, 576))):
        bands24 = [native_codec.encode_levels(lvs[b]) for b in range(3)]
        buf24 = torch.frombuffer(bytearray(b"".join(bands24)),
                                 dtype=torch.uint8).to(dev)
        ends24 = np.cumsum([len(x) for x in bands24]).tolist()
        ok, _ = scan_kernels(label, buf24, ends24, L=lvs.shape[2],
                             nb=lvs.shape[1])
        check(ok, f"K6+K8 accept the {label} ({ends24[-1]} bytes)")
        resume_streams[label] = (buf24, ends24[-1], lvs.shape[2])

    def survivor_rows(surv):
        """A survivor list's first n (byte, bits, index) rows, by byte."""
        k = int(surv.n[0])
        order = torch.argsort(surv.q[:k])
        return torch.stack([surv.q[:k][order], surv.c[:k][order].long(),
                            surv.w[:k][order].long()])

    def resume_kernels(label, buf, n_b, L_r):
        """K6' vs its plain versions (bit-equal) on every byte of a buffer
        at each cap of ``two_sweep_caps``: the list form on q = every byte;
        the walkers live at the cap resumed by the list form from their
        carried state, all of them and the first half (n_live), kernel and
        plain alike, giving the single sweep's table; the range form
        (sweep 1's table, and its survivors as a set), the list form's
        table output over them (sweep 2) and end_table(cap).  Returns the
        largest differences from the plain versions: (range form, list
        form)."""
        P = buf.shape[0]
        q = torch.arange(P, dtype=torch.int64, device=dev)
        zero = torch.zeros(P, dtype=torch.int32, device=dev)
        one_t = torch.ones((), dtype=torch.int64, device=dev)
        E1 = K.scan_walk(buf, n_b, L_r)
        budget = K._walk_units(L_r)
        err_c, err_r, good, live_at = 0, 0, True, []
        for cap in two_sweep_caps(L_r):
            steps = min(cap, budget)
            plain = K.scan_walk_resume_plain(buf, n_b, L_r, q, steps, zero,
                                             zero, one_t * P)
            got = K.scan_walk_resume(buf, n_b, L_r, q, cap)
            err_r = max(err_r, *(max_diff(g, p) for g, p in zip(got, plain)))
            live = plain[0] == -2
            k = int(live.sum())
            live_at.append(k)
            length = plain[0].clone()
            if k:
                ql, cl, wl = q[live], plain[1][live], plain[2][live]
                res = K.scan_walk_resume(buf, n_b, L_r, ql, budget - cap, cl,
                                         wl)
                res_p = K.scan_walk_resume_plain(buf, n_b, L_r, ql,
                                                 budget - cap, cl, wl,
                                                 one_t * k)
                part = K.scan_walk_resume(buf, n_b, L_r, ql, budget - cap, cl,
                                          wl, n_live=one_t * (k // 2))
                err_r = max(err_r,
                            *(max_diff(g, p) for g, p in zip(res, res_p)),
                            *(max_diff(g[:k // 2], p[:k // 2])
                              for g, p in zip(part, res_p)))
                good &= (bool((part[0][k // 2:] == -2).all())
                         and torch.equal(part[1][k // 2:], cl[k // 2:])
                         and torch.equal(part[2][k // 2:], wl[k // 2:]))
                length[live] = res_p[0]
            good &= torch.equal(
                torch.where(length >= 0, q + length, P + 1).to(torch.int32),
                E1[:P])
            E_c, surv = K.scan_walk_capped(buf, n_b, L_r, cap)
            E_cp, surv_p = K.scan_walk_capped_plain(buf, n_b, L_r, cap)
            err_c = max(err_c, max_diff(E_c, E_cp))
            good &= (surv is None) == (surv_p is None) == (cap >= budget)
            if surv is not None:
                good &= torch.equal(survivor_rows(surv),
                                    survivor_rows(surv_p))
                K.scan_walk_resume(buf, n_b, L_r, surv.q, budget - cap,
                                   surv.c, surv.w, surv.n, table=E_c)
                K.scan_walk_resume_plain(buf, n_b, L_r, surv_p.q,
                                         budget - cap, surv_p.c, surv_p.w,
                                         surv_p.n, table=E_cp)
                err_r = max(err_r, max_diff(E_c, E_cp))
            good &= torch.equal(E_c, E1) and torch.equal(
                DS.end_table(buf, n_b, L_r, cap=cap), E1)
        check(err_c == 0 and err_r == 0 and good,
              f"K6' on the {label} ({P}-byte buffer, n_bytes {n_b}, L = "
              f"{L_r}), caps {two_sweep_caps(L_r)}: the list form on every "
              f"byte bit-equal to plain; {live_at} walkers live at the caps "
              "resumed by the list form (all, and the first half by "
              "n_live), kernel and plain alike; the range form's table and "
              "survivors (sweep 1) and the list form's table over them "
              "(sweep 2) bit-equal to plain; the single sweep's table")
        return err_c, err_r

    for label_r, (buf_r, n_r, L_r) in resume_streams.items():
        errs_r = resume_kernels(label_r, buf_r, n_r, L_r)
        for name_r, e_r in zip(("scan_walk_capped", "scan_walk_resume"),
                               errs_r):
            scan_err[name_r] = max(scan_err[name_r], e_r)

    def resumed_bytes(q, c0, out, n_b):
        """Stream bytes that resumed walks cover, counted once: each from
        the byte of its resume position to the last byte it reads (the
        header it stops at, unless it ran out of units there)."""
        length, c_end = out[0].long(), out[1].long()
        first = (q + (c0.long() >> 3)).clamp(max=n_b)
        last = (q + torch.where(length == -2, c_end + 7, c_end + 15)
                // 8).clamp(max=n_b)
        ones = torch.ones_like(q)
        d = torch.zeros(n_b + 1, dtype=torch.int64, device=dev)
        d.index_add_(0, first, ones).index_add_(0, last, -ones)
        return int((d.cumsum(0)[:n_b] > 0).sum())

    # The K6' rows: the two kernels one end_table(cap=12) call launches on
    # the image stream, each against the bytes it moves.  Sweep 1 reads the
    # stream and writes the table, its survivors (16 bytes each) and their
    # count; sweep 2 reads the count, the survivors and the stream bytes
    # their resumed walks cover, and writes their table entries.
    cap_r, steps_r = 12, K._walk_units(L) - 12
    E_r, surv_r = K.scan_walk_capped(img_buf, P_img, L, cap_r)
    n_surv = int(surv_r.n[0])
    span_r = resumed_bytes(surv_r.q[:n_surv], surv_r.c[:n_surv],
                           K.scan_walk_resume(img_buf, P_img, L,
                                              surv_r.q[:n_surv], steps_r,
                                              surv_r.c[:n_surv],
                                              surv_r.w[:n_surv]), P_img)
    results["scan_walk_capped"] = dict(
        fn=lambda: K.scan_walk_capped(img_buf, P_img, L, cap_r),
        plain=lambda: K.scan_walk_capped_plain(img_buf, P_img, L, cap_r),
        nbytes=P_img + 4 * (P_img + 2) + 16 * n_surv + 8,
        shape=f"sweep 1 of end_table(cap=12): {P_img} walkers, {n_surv} "
              f"survivors, stream {P_img} bytes")
    results["scan_walk_resume"] = dict(
        fn=lambda: K.scan_walk_resume(img_buf, P_img, L, surv_r.q, steps_r,
                                      surv_r.c, surv_r.w, surv_r.n,
                                      table=E_r),
        plain=lambda: K.scan_walk_resume_plain(
            img_buf, P_img, L, surv_r.q, steps_r, surv_r.c, surv_r.w,
            surv_r.n, table=E_r),
        nbytes=8 + 20 * n_surv + span_r,
        shape=f"sweep 2 of end_table(cap=12): {n_surv} survivors resumed "
              f"for {steps_r} units, {span_r} stream bytes")
    q_img = torch.arange(P_img, dtype=torch.int64, device=dev)

    dec = BandDecoder(cfg).to(dev)
    pix_k = K.decode_blocks(flat, dec.op_t, dec.deq, bs=dec.bs)
    pix_p = K.decode_blocks_plain(flat, dec.op_t, dec.deq, bs=dec.bs)
    nv, nh, D = cfg.blocks_high, cfg.blocks_wide, dec.D

    def planes(pix):
        planes3 = deblockify(pix.reshape(3, nv, nh, D, D))
        return crop(planes3, h, w).cpu().numpy()

    got, want_p = planes(pix_k), planes(pix_p)
    flat_np = flat.cpu().numpy().reshape(3, -1, L)
    for b in range(3):
        ref, ties = parity.decode_reference_and_ties(cfg, flat_np[b])
        parity.assert_tie_equal(got[b], want_p[b], ties,
                                f"K4 vs plain band {b}")
        parity.assert_tie_equal(got[b], ref, ties, f"K4 vs f64 band {b}")
    k4_err = int(np.abs(got.astype(np.int64) - want_p).max())  # 0 or 1
    check(True, f"K4: equal to plain and to the f64 reference except +-1 at "
          f"ties (max |diff| vs plain {k4_err}, "
          f"{int((got != want_p).sum())} tie flips)")

    def k4_entry(lv_t, dec_t, err):
        """K4's timing closures and counts on (N, K) levels and a decoder
        (as ``BandDecoder`` calls it: the (K, M) decode operator, each pixel
        stored to its bs x bs places), with the full-f32 ``torch.matmul`` of
        the same operands: the distinct product, M = d*d columns."""
        a32 = (lv_t * dec_t.deq).to(torch.float32)
        n_t, K_t = lv_t.shape
        M_t, bs_t = dec_t.op_t.shape[1], dec_t.bs

        def library():
            with full_f32_matmul():
                return torch.matmul(a32, dec_t.op_t)

        return dict(
            err=err, fn=lambda: K.decode_blocks(lv_t, dec_t.op_t, dec_t.deq,
                                                bs=bs_t),
            plain=lambda: K.decode_blocks_plain(lv_t, dec_t.op_t, dec_t.deq,
                                                bs=bs_t),
            library=library, rate=TF32_FLOP_PER_S,
            shape=f"N={n_t}, K={K_t}, M={M_t}, bs={bs_t}",
            nbytes=4 * n_t * K_t + n_t * M_t * bs_t * bs_t
            + 4 * dec_t.op_t.numel() + 4 * dec_t.deq.numel(),
            flops=2 * n_t * K_t * M_t)

    # K4's error before rounding, against the exact sums of its inputs.
    margins = {d_e: [] for _, _, d_e in K4_EDGE_M}
    k4_x, _ = k4_against_exact(K, full_f32_matmul, flat, dec.op_t, dec.deq,
                               bs=dec.bs)
    margins[8].append((k4_x["margin"], k4_x["margin_plain"]))
    check(True, f"K4 on the image's levels vs their exact sums: "
          f"{k4_x['flips_exact']} tie flips ({k4_x['ties']} tie positions)")
    results["decode_blocks"] = k4_entry(flat, dec, k4_err)
    dec24 = BandDecoder(cfg24).to(dev)
    flat24 = torch.from_numpy(lv24.reshape(-1, 576)).to(dev)
    k4_24, _ = k4_against_exact(K, full_f32_matmul, flat24, dec24.op_t,
                                dec24.deq, bs=dec24.bs)
    margins[24].append((k4_24["margin"], k4_24["margin_plain"]))
    check(True, f"K4 at d = 24 on BASELINE (3)'s levels (N = "
          f"{flat24.shape[0]}, K = 576, M = {dec24.op_t.shape[1]}, bs "
          f"{dec24.bs}): equal "
          f"to plain and to the exact sums' rounding except +-1 at ties "
          f"({k4_24['flips_plain']} flips vs plain, {k4_24['flips_exact']} "
          f"vs exact, {k4_24['ties']} tie positions)")
    results[K4_D24] = k4_entry(flat24, dec24, k4_24["err"])
    # The design's edges: output widths, ragged row tiles, a zero block,
    # saturating blocks, dequantized values near 2**22 and 2**24.
    rng_k4 = np.random.default_rng(13)
    for M_e, bs_e, d_e in K4_EDGE_M:
        cfg_e = Configuration(
            width=64, height=64, block_size=bs_e, dct_size=d_e,
            quantization=(QuantizationMethod("qtable") if d_e == 8 else
                          QuantizationMethod("divide", divisor=1000)))
        dec_e = BandDecoder(cfg_e).to(dev)
        L_e = d_e * d_e
        check(dec_e.op_t.shape[1] * bs_e * bs_e == M_e,
              f"K4 edge decoder: M = {dec_e.op_t.shape[1]}, bs {bs_e}, "
              f"{M_e} pixels a block")
        comb_e = torch.from_numpy(np.ascontiguousarray(
            T.combined_decode_operator(d_e, bs_e, "DCT").T,
            np.float32)).to(dev)
        for N_e in K4_EDGE_N:
            lv_e = np.where(rng_k4.random((N_e, L_e)) < 0.3,
                            rng_k4.integers(-40, 41, (N_e, L_e)), 0)
            lv_e[:, 0] = rng_k4.integers(-60, 61, N_e)
            sat = N_e >= 3
            if sat:
                lv_e[0] = 0                              # an all-zero block
                lv_e[1:3] = 0
                lv_e[1, 0], lv_e[2, 0] = 16383, -16383   # all-saturating
            lv_t = torch.from_numpy(lv_e.astype(np.int32)).to(dev)
            r, got = k4_against_exact(K, full_f32_matmul, lv_t, dec_e.op_t,
                                      dec_e.deq, bs=bs_e)
            check(torch.equal(K.decode_blocks(lv_t, dec_e.op_t, dec_e.deq,
                                              bs=bs_e),
                              K.decode_blocks(lv_t, comb_e, dec_e.deq)),
                  f"K4 M = {M_e}, N = {N_e}: bit-equal to K4 on the combined "
                  "operator")
            margins[d_e].append((r["margin"], r["margin_plain"]))
            k4_err = max(k4_err, r["err"])
            check(not sat or (bool((got[1] == 255).all())
                              and bool((got[2] == 0).all())),
                  f"K4 M = {M_e}, N = {N_e}: equal to plain and to the exact "
                  f"sums' rounding except +-1 at ties ({r['flips_plain']} / "
                  f"{r['flips_exact']} flips, {r['ties']} ties)"
                  + ("; saturating blocks all 255 and all 0" if sat else ""))
        big = torch.full((L_e,), 1024, dtype=torch.int32, device=dev)
        for hi in K4_BIG_LEVELS:
            lv_t = torch.from_numpy(rng_k4.integers(
                -hi, hi + 1, (257, L_e)).astype(np.int32)).to(dev)
            r, _ = k4_against_exact(K, full_f32_matmul, lv_t, dec_e.op_t, big,
                                    bs=bs_e)
            margins[d_e].append((r["margin"], r["margin_plain"]))
            k4_err = max(k4_err, r["err"])
            check(True, f"K4 M = {M_e}, |lv| <= {hi} times 1024 (up to "
                  f"{hi * 1024}, 2**22 = {1 << 22}, 2**24 = {1 << 24}): "
                  f"within the contract ({r['flips_plain']} / "
                  f"{r['flips_exact']} flips)")
    results["decode_blocks"]["err"] = k4_err
    k4_margin = {}
    for d_m, ms in margins.items():
        K_m = d_m * d_m
        k4_margin[d_m] = max(m for m, _ in ms)
        b_m = 1.003 * (min(K_m, 8) + 2) + 0.51 * -(-K_m // 8) + 6.01
        log(f"  K4 error before rounding at d = {d_m} (K = {K_m}), the most "
            f"over {len(ms)} cases, in units of 2**-23 sum|terms|: "
            f"{k4_margin[d_m]:.3f} (full-f32 cuBLAS "
            f"{max(p for _, p in ms):.3f}); the split's derived bound "
            f"B({K_m}) = {b_m:.1f}, the contract's {K_m + 16}")
    results["decode_blocks"]["error_eps32"] = k4_margin[8]
    results[K4_D24]["error_eps32"] = k4_margin[24]

    def k5_closures(vec, op_t, vecs):
        return (lambda: K.encode_blocks(vec, op_t, *vecs),
                lambda: K.encode_blocks_plain(vec, op_t, *vecs))

    k5_err = 0
    k5_margins = {}      # d -> [(K5's error, the full-f32 product's)]

    def k5_case(label, vec, d5, op, op_t, quants):
        """K5 on (N, d*d) pixel blocks with each quantizer: equal to its
        plain version and to the f64 reference except +-1 at provable
        ties; and its sums before the epilogue (``encode_blocks_sums``)
        against the exact sums of its f32 inputs, in units of 2**-23
        sum|terms|, beside the full-f32 cuBLAS product's."""
        nonlocal k5_err
        vec_np = vec.to(torch.float64).cpu().numpy()
        for qname, qparams in quants:
            ev = Q.epilogue_vectors(QuantizationMethod(qname, **qparams), d5)
            vecs = [torch.from_numpy(v.astype(np.float32)).to(dev)
                    for v in ev]
            got = K.encode_blocks(vec, op_t, *vecs)
            plain = K.encode_blocks_plain(vec, op_t, *vecs)
            ref, ties = parity.blocks_reference_and_ties(vec_np, op, *ev)
            g, p = got.cpu().numpy(), plain.cpu().numpy()
            tag = (f"K5 d={d5} N={vec.shape[0]} {label} {qname} "
                   f"{qparams or ''}")
            parity.assert_tie_equal(g, p, ties, f"{tag} vs plain")
            parity.assert_tie_equal(g, ref, ties, f"{tag} vs f64")
            k5_err = max(k5_err, max_diff(got, plain))
            check(True, f"{tag}: equal to plain and to the f64 reference "
                  f"except +-1 at ties ({int((g != p).sum())} tie flips vs "
                  f"plain, {int((g != ref).sum())} vs f64, "
                  f"{int(ties.sum())} tie positions)")
        sums = K.encode_blocks_sums(vec, op_t).double()
        with full_f32_matmul():
            mm = torch.matmul(vec, op_t).double()
        o64 = op_t.double()
        v64 = vec.double()
        exact, terms = v64 @ o64, v64.abs() @ o64.abs()
        pos = terms > 0
        scale = terms[pos] * EPS32
        k5_margins.setdefault(d5, []).append(
            (float(((sums - exact).abs()[pos] / scale).max()),
             float(((mm - exact).abs()[pos] / scale).max())))

    for d5, n5, quants in K5_CASES:
        vec = blockify(img_t.to(torch.float32), d5).reshape(-1, d5 * d5)
        vec = vec[:n5].contiguous()
        op = T.dft_encode_operator(d5)
        op_t = torch.from_numpy(op.T.astype(np.float32)).contiguous().to(dev)
        k5_case("image blocks", vec, d5, op, op_t, quants)
        if d5 == 8:
            ev = Q.epilogue_vectors(QuantizationMethod("none"), d5)
            vecs = [torch.from_numpy(v.astype(np.float32)).to(dev)
                    for v in ev]
            fn, plain_fn = k5_closures(vec, op_t, vecs)
            N5, L5 = vec.shape

            def k5_library(vec=vec, op_t=op_t):
                with full_f32_matmul():
                    return torch.matmul(vec, op_t)

            k5_product = (lambda vec=vec, op_t=op_t:
                          K.encode_blocks_sums(vec, op_t))
            results["encode_blocks"] = dict(
                fn=fn, plain=plain_fn, plain_reps=50,
                library=k5_library, rate=TF32_FLOP_PER_S,
                shape=f"N={N5}, L={L5}",
                nbytes=8 * N5 * L5 + 4 * op_t.numel()
                + 4 * sum(v.numel() for v in vecs),
                flops=2 * N5 * L5 * L5)
    # K5 at its design's edges: both tiles' row edges (128 x 64 up to 64
    # coefficients, 64 x 128 above), d = 3 (K = 9: 4-byte copies, element
    # stores), d = 24; fractional pixel means (3x3 and 2x2 blocks), x one
    # element off 16-byte alignment in every other case, every quantizer.
    rng_k5 = np.random.default_rng(19)
    for d5, ns, quants in K5_EDGES:
        L5 = d5 * d5
        op = T.dft_encode_operator(d5)
        op_t = torch.from_numpy(op.T.astype(np.float32)).contiguous().to(dev)
        for i, n5 in enumerate(ns):
            bs5 = 3 if i % 2 == 0 else 2
            means = (rng_k5.integers(0, 255 * bs5 * bs5 + 1, (n5, L5))
                     / (bs5 * bs5)).astype(np.float32)
            vec = torch.from_numpy(means).to(dev)
            label = f"means of {bs5}x{bs5}"
            if i % 2 == 1:
                flat5 = torch.empty(n5 * L5 + 1, dtype=torch.float32,
                                    device=dev)
                flat5[1:] = vec.reshape(-1)
                vec = flat5[1:].view(n5, L5)
                check(vec.data_ptr() % 16 != 0 and vec.is_contiguous(),
                      f"K5 d={d5} N={n5}: x one element off 16-byte "
                      "alignment")
                label += ", unaligned"
            k5_case(label, vec, d5, op, op_t,
                    quants if n5 < 100_000 else quants[:2])
    results["encode_blocks"]["err"] = k5_err
    k5_margin = {}
    for d5, ms in sorted(k5_margins.items()):
        K_m = d5 * d5
        k5_margin[d5] = max(m for m, _ in ms)
        b_m = 1.003 * (min(K_m, 8) + 2) + 0.51 * -(-K_m // 8) + 6.01
        check(k5_margin[d5] <= b_m,
              f"K5 error before the epilogue at d = {d5} (K = {K_m}), the "
              f"most over {len(ms)} cases, in units of 2**-23 sum|terms|: "
              f"{k5_margin[d5]:.3f} (full-f32 cuBLAS "
              f"{max(p for _, p in ms):.3f}), within the split's derived "
              f"bound B({K_m}) = {b_m:.1f} (the contract's {K_m + 16})")
    results["encode_blocks"]["error_eps32"] = k5_margin[8]

    # K3 at its design's edges: tiles of K.decode_stream_plan(L) blocks
    # (N around a tile), L = 9, 64, 576; adversarial, all-EOB and
    # all-+-16383 blocks (whose tile spans overflow the staged budget), a
    # buffer longer than its stream, and the garbage starts of a device
    # scan whose check failed: bit-equal to the plain version, and to the
    # levels where the starts are the stream's.
    rng_k3 = np.random.default_rng(23)
    k3_err = 0

    def k3_case(label, lv_np, starts_np=None, tail=0):
        nonlocal k3_err
        n3, L3 = lv_np.shape
        raw3 = native_codec.encode_levels(lv_np)
        true = starts_np is None
        if true:
            starts_np = native_codec.scan_offsets(raw3, n3, L3)
        extra = rng_k3.integers(0, 256, tail, dtype=np.uint8).tobytes()
        buf3 = torch.frombuffer(bytearray(raw3 + extra),
                                dtype=torch.uint8).to(dev)
        st3 = torch.from_numpy(np.ascontiguousarray(
            starts_np, np.int64)).to(dev)
        got = K.decode_stream_blocks(buf3, st3, L3)
        plain = K.decode_stream_blocks_plain(buf3, st3, L3)
        k3_err = max(k3_err, max_diff(got, plain))
        want = torch.from_numpy(lv_np).to(dev) if true else plain
        plan = K.decode_stream_plan(L3)
        spans = [int(starts_np[min(i + plan.tile, n3) - 1])
                 - int(starts_np[i]) for i in range(0, n3, plan.tile)]
        check(torch.equal(got, plain) and torch.equal(got, want),
              f"K3 {label} (N = {n3}, L = {L3}, {len(raw3)} + {tail} "
              f"bytes; tiles of {plan.tile}, widest span {max(spans)} + "
              f"halo {plan.halo} bytes, budget {K.DECODE_SPAN_BYTES}): "
              "bit-equal to plain" + (" and to the levels" if true else ""))
        return raw3, max(spans) + plan.halo

    def k3_levels(n3, L3, seed):
        """``adversarial_levels`` where L has room for its runs, else
        sparse random levels with bare-EOB and all-+-16383 blocks."""
        if L3 >= 64:
            return adversarial_levels(n3, L3, seed=seed)
        r = np.random.default_rng(seed)
        lv3 = np.where(r.random((n3, L3)) < 0.3,
                       r.integers(-16383, 16384, (n3, L3)), 0)
        lv3[::5] = 0
        lv3[1::7] = r.choice([-16383, 16383], lv3[1::7].shape)
        return lv3.astype(np.int32)

    for L3 in K3_EDGE_L:
        T3 = K.decode_stream_plan(L3).tile
        for n3 in sorted({1, max(T3 - 1, 1), T3, T3 + 1, 49153}):
            k3_case("adversarial levels", k3_levels(n3, L3, n3),
                    tail=37 if n3 == T3 + 1 else 0)
        k3_case("all-EOB blocks", np.zeros((T3 + 1, L3), np.int32))
        dense = rng_k3.choice([-16383, 16383], (T3 + 1, L3)).astype(np.int32)
        _, span3 = k3_case("every coefficient at +-16383", dense)
        if L3 >= 64:
            check(span3 > K.DECODE_SPAN_BYTES,
                  f"  a tile of them spans {span3} bytes, over the "
                  "budget: its walks read on from global memory")
        lv3 = k3_levels(2 * T3 + 3, L3, L3)
        raw3, _ = k3_case("adversarial levels, the garbage cases' stream", lv3)
        P3 = len(raw3)
        n3 = lv3.shape[0]
        for how, st in (
                ("random", rng_k3.integers(0, P3 + 2, n3)),
                ("descending", np.sort(rng_k3.integers(0, P3 + 2, n3))[::-1]),
                ("all P", np.full(n3, P3)), ("all P + 1", np.full(n3, P3 + 1)),
                ("P to P + 2**40", rng_k3.integers(P3, P3 + (1 << 40), n3))):
            k3_case(f"garbage starts, {how}", lv3, starts_np=st)
    results["decode_stream_blocks"]["err"] = max(
        results["decode_stream_blocks"]["err"], k3_err)
    img_starts = torch.cumsum(img_bb.to(torch.int64), 0) - img_bb.to(
        torch.int64)
    raw24 = b"".join(native_codec.encode_levels(lv24[b]) for b in range(3))
    n24 = lv24.shape[0] * lv24.shape[1]
    buf24 = torch.frombuffer(bytearray(raw24), dtype=torch.uint8).to(dev)
    st24 = torch.from_numpy(native_codec.scan_offsets(raw24, n24, 576).astype(
        np.int64)).to(dev)
    check(torch.equal(K.decode_stream_blocks(buf24, st24, 576),
                      torch.from_numpy(lv24.reshape(n24, 576)).to(dev)),
          f"K3 on BASELINE (3)'s d = 24 stream ({len(raw24)} bytes): the "
          "levels")
    k3_streams = {
        f"{h}x{w} stream (N = {n_blocks}, L = {L}, {img_ends[-1]} bytes)":
            (img_buf, img_starts, L),
        f"d = 24 stream (N = {n24}, L = 576, {len(raw24)} bytes)":
            (buf24, st24, 576)}

    # K1 on BASELINE (3)'s d = 24 levels (its own line in the kernels JSON).
    W24 = -(-int(DC.block_bytes_of(flat24).max()) // 4)
    rows24_k, bb24_k = K.encode_stream_rows(flat24, W24)
    rows24_p, bb24_p = K.encode_stream_rows_plain(flat24, W24)
    check(torch.equal(rows24_k, rows24_p) and torch.equal(bb24_k, bb24_p),
          f"K1 on BASELINE (3)'s d = 24 levels (N = {n24}, L = 576, W = "
          f"{W24}): rows and block bytes bit-equal to plain")
    results[K1_L576] = dict(
        err=max(max_diff(rows24_k, rows24_p), max_diff(bb24_k, bb24_p)),
        fn=lambda lv=flat24, w=W24: K.encode_stream_rows(lv, w),
        plain=lambda lv=flat24, w=W24: K.encode_stream_rows_plain(lv, w),
        plain_reps=1, nbytes=4 * n24 * (576 + W24 + 1),
        shape=f"N={n24}, L=576, W={W24}")

    # K1 and K9 at their design's edges (csrc/bit_writer.cuh: a group of
    # lanes a block, each lane a run of slots and their bits, rows staged
    # in shared memory up to K.ENC_ROW_MAX_WORDS words): L = 9 ... 1024
    # (K9 where L <= 75), N = 1, 31, 32, 33, the plan's tile T - 1 and T +
    # 1 and 49,153 (prefixes of one level set: a block's row depends on its
    # levels alone), W exact, W - 1 and W - 3 (truncated rows, exact block
    # bytes) and one word over the staged-row budget (the lanes write the
    # global row): bit-equal to the plain versions through the wrappers'
    # plans and at every group size (one plain call per L at the widest W,
    # cut to each width: a narrower row keeps the wider one's first words),
    # K9's rows also to K1's and _unit_groups' block bytes to
    # K1's, and K1 + K2 at W exact to the host C++ encoder's stream.
    k1_err = k9_err = 0
    for L1 in K1_EDGE_L:
        lv1_np = writer_levels(max(K1_EDGE_N), L1, L1, K.ENC_LANES)
        lv1 = torch.from_numpy(lv1_np).to(dev)
        bb1 = DC.block_bytes_of(lv1)
        W_top = max(-(-int(bb1.max()) // 4), K.ENC_ROW_MAX_WORDS + 1)
        rows_p1, bb_p1 = K.encode_stream_rows_plain(lv1, W_top)
        tables = L1 <= DC.TABLES_MAX_L
        if tables:
            cb1, vh1, vl1, bbt1 = DC._unit_groups(lv1)
            rows9_p1 = K.encode_stream_rows_tables_plain(cb1, vh1, vl1, W_top)
            check(torch.equal(rows9_p1, rows_p1) and torch.equal(bbt1, bb_p1),
                  f"plain K9 = plain K1 at L = {L1}")
        tiles = {K.encode_rows_plan(n_t, L1 + k, -(-int(bb1[:n_t].max())
                                                   // 4), sms, 1 + k).tile
                 for n_t in K1_EDGE_N for k in (0, 1)}
        for n1 in sorted({*K1_EDGE_N, *(t + d for t in tiles for d in (-1, 1)
                                        if t + d > 0)}):
            W_n = -(-int(bb1[:n1].max()) // 4)
            widths = sorted({W_n, max(W_n - 1, 1), max(W_n - 3, 1),
                             K.ENC_ROW_MAX_WORDS + 1})
            plans = []
            for w in widths:
                want_r, want_b = rows_p1[:n1, :w], bb_p1[:n1]
                rows_k, bb_k = K.encode_stream_rows(lv1[:n1], w)
                k1_err = max(k1_err, max_diff(rows_k, want_r),
                             max_diff(bb_k, want_b))
                ok = torch.equal(rows_k, want_r) and torch.equal(bb_k, want_b)
                if tables:
                    rows9 = K.encode_stream_rows_tables(
                        cb1[:n1], vh1[:n1], vl1[:n1], w)
                    k9_err = max(k9_err, max_diff(rows9, want_r))
                    ok = ok and torch.equal(rows9, want_r)
                # every group size, through the uncounted launchers
                for G in K.ENC_LANES:
                    r_g, b_g = K._encode_rows(lv1[:n1], w,
                                              K.encode_rows_fit(G, L1, w))
                    k1_err = max(k1_err, max_diff(r_g, want_r),
                                 max_diff(b_g, want_b))
                    ok = ok and torch.equal(r_g, want_r) and torch.equal(
                        b_g, want_b)
                    if tables:
                        r9_g = K._encode_tables(
                            cb1[:n1], vh1[:n1], vl1[:n1], w,
                            K.encode_rows_fit(G, L1 + 1, w, 2))
                        k9_err = max(k9_err, max_diff(r9_g, want_r))
                        ok = ok and torch.equal(r9_g, want_r)
                if w == W_n:
                    total1 = int(bb_k.to(torch.int64).sum())
                    ok = ok and (K.deposit_rows(rows_k, bb_k, total1).cpu()
                                 .numpy().tobytes()
                                 == native_codec.encode_levels(lv1_np[:n1]))
                p1 = K.encode_rows_plan(n1, L1, w, sms)
                plans.append(f"{w} ({p1.lanes} lanes, tile {p1.tile}, "
                             f"{'shared' if p1.smem_rows else 'global'})")
                check(ok, f"K1{' and K9' if tables else ''}, L = {L1}, N = "
                      f"{n1}, W = {w}: bit-equal to plain through the plan "
                      "and at every group size"
                      + (" and to each other" if tables else "")
                      + (", K1 + K2 = the host C++ stream" if w == W_n
                         else ""))
            log(f"    (L = {L1}, N = {n1}: W = " + ", ".join(plans) + ")")
    results["encode_stream_rows"]["err"] = max(
        results["encode_stream_rows"]["err"], k1_err)
    results["encode_stream_rows_tables"]["err"] = max(
        results["encode_stream_rows_tables"]["err"], k9_err)

    log("== phase 4: main path (compress_ycbcr -> decompress_to_ycbcr, "
        "scan='host')")
    images = {hw: synth_image(*hw) for hw in SIZES}
    runs = {}
    K.reset_launch_counts()
    for hw, im in images.items():
        blob = compress_ycbcr(im, cfg_for(*hw))
        runs[hw] = (blob, decompress_to_ycbcr(blob, scan="host"))
    counts = K.launch_counts()
    log(f"  launch counts over the main-path run: {counts}")
    check(all(counts[name] > 0 for name in MAIN_PATH),
          "every kernel of the path was launched")
    for (h, w), (blob, rec) in runs.items():
        cfg = cfg_for(h, w)
        im = images[(h, w)]
        log(f"  -- {h}x{w}: {len(blob)} bytes "
            f"({im.nbytes / len(blob):.2f}x)")
        cfg2, data = container.read_data(blob)
        streams = [data.y, data.cb, data.cr]
        check(cfg2 == cfg and len(container.create_header(cfg)) + 12
              + sum(map(len, streams)) == len(blob), "container re-parses")
        img_t = torch.from_numpy(im).to(dev).permute(2, 0, 1)
        lv = BandEncoder(cfg).to(dev)(img_t).cpu().numpy()     # (3, N, L)
        for b in range(3):
            check(native_codec.encode_levels(lv[b]) == streams[b],
                  f"band {b} stream byte-equal to the host C++ encoder's")
            ref, ties = parity.encode_reference_and_ties(cfg, im[:, :, b])
            parity.assert_tie_equal(lv[b], ref, ties, f"levels band {b}")
        check(True, "levels equal the f64 reference except +-1 at ties")
        p = psnr(im, rec)
        check(rec.shape == im.shape and rec.dtype == np.uint8
              and p > PSNR_MIN_DB, f"decoded {rec.shape} uint8, PSNR "
              f"{p:.2f} dB > {PSNR_MIN_DB}")
        # the plain-version decode path on the card
        nb = cfg.num_blocks
        buf = b"".join(streams)
        stream = torch.frombuffer(bytearray(buf), dtype=torch.uint8).to(dev)
        off = np.cumsum([0] + [len(s) for s in streams[:2]])
        starts = torch.from_numpy(np.concatenate(
            [native_codec.scan_offsets(s, nb, 64).astype(np.int64) + o
             for s, o in zip(streams, off)])).to(dev)
        lv_p = K.decode_stream_blocks_plain(stream, starts, 64)
        bd = BandDecoder(cfg).to(dev)
        pix = K.decode_blocks_plain(lv_p, bd.op_t, bd.deq, bs=bd.bs)
        plain = crop(deblockify(pix.reshape(3, cfg.blocks_high,
                                            cfg.blocks_wide, bd.D, bd.D)),
                     h, w).cpu().numpy()
        for b in range(3):
            _, ties = parity.decode_reference_and_ties(cfg, lv[b])
            parity.assert_tie_equal(rec[:, :, b], plain[b], ties,
                                    f"planes vs plain path band {b}")
        check(True, "planes equal the plain-version path's except +-1 at "
              f"ties ({int((rec.transpose(2, 0, 1) != plain).sum())} flips)")

    log("  -- the caller's TF32 settings")
    (h, w), (blob, _) = next(iter(runs.items()))
    matmul = torch.backends.cuda.matmul
    for label, set_tf32 in (
            ("set_float32_matmul_precision('high')",
             lambda: torch.set_float32_matmul_precision("high")),
            ("cuda.matmul.fp32_precision = 'tf32'",
             lambda: setattr(matmul, "fp32_precision", "tf32"))):
        set_tf32()
        try:
            blob_tf32 = compress_ycbcr(images[(h, w)], cfg_for(h, w))
            left = matmul.fp32_precision
        finally:
            torch.set_float32_matmul_precision("highest")
            matmul.fp32_precision = "none"
        check(blob_tf32 == blob and left == "tf32",
              f"after {label}: the {h}x{w} container is the same bytes "
              "(full f32 products) and the caller's setting is left on")

    log("== phase 4b: host-free decode (scan='device') and the rest of "
        "the API")
    sizes = list(runs)
    # 512x512 at bs 2: 1,024 blocks a band, the longest band that keeps
    # K6 + K8 (K8's short form); the main sizes' bands take K10.
    short_hw = (512, 512)
    short_blob = compress_ycbcr(synth_image(*short_hw), cfg_for(*short_hw))
    short_host = decompress_to_ycbcr(short_blob, scan="host")
    check(cfg_for(*short_hw).num_blocks == K.CHASE_DIRECT_MAX
          and not DS.segmented(K.CHASE_DIRECT_MAX)
          and all(DS.segmented(cfg_for(*hw).num_blocks) for hw in sizes),
          f"{short_hw[0]}x{short_hw[1]} bands keep K6 + K8, the main sizes' "
          "take K10")
    K.reset_launch_counts()
    short_dev = decompress_to_ycbcr(short_blob, scan="device")
    dev_recs = {hw: decompress_to_ycbcr(blob, scan="device")
                for hw, (blob, _) in runs.items()}
    dev_planes = {hw: decompress_to_device(blob, scan="device")
                  for hw, (blob, _) in runs.items()}
    band_starts = {}
    for hw, (blob, _) in runs.items():
        cfg, data = container.read_data(blob)
        band_starts[hw] = [
            entropy.scan_offsets(s, cfg.num_blocks, L, scan="device")
            for s in (data.y, data.cb, data.cr)]
    mixed = [runs[sizes[0]][0], runs[sizes[1]][0], runs[sizes[0]][0]]
    many = {scan: decompress_many(mixed, scan=scan)
            for scan in ("host", "device")}
    many_blobs = {hw: compress_many([images[hw], np.roll(images[hw], 64, 1),
                                     images[hw]], cfg_for(*hw))
                  for hw in sizes}
    errors = {}
    for scan in ("host", "device"):
        try:
            decompress_to_ycbcr(runs[sizes[0]][0][:-3], scan=scan)
        except (BadStreamError, BadRleCodeError) as e:
            errors[scan] = type(e)
    counts_hf = K.launch_counts()
    log(f"  launch counts over the host-free run: {counts_hf}")
    # One K3 launch per decode: the short-band one, two per size, one per
    # decompress_many image and scan, and the truncated container's
    # device-scan decode, which launches before its check is read.  A
    # decode moved to the host scan would launch K3 a second time.
    decodes = 1 + 2 * len(sizes) + 2 * len(mixed) + 1
    check(counts_hf["decode_stream_blocks"] == decodes,
          f"the host-free run decoded {decodes} times, each once "
          f"(K3 launches: {counts_hf['decode_stream_blocks']})")
    # Device-scan decodes of the main sizes: two per size, the mixed
    # decompress_many and the truncated container.
    long_decodes = 2 * len(sizes) + len(mixed) + 1
    check(counts_hf["segment_scan"] == long_decodes
          and counts_hf["chase_starts_multi"] == 1,
          f"K10 scanned each of the {long_decodes} device-scan decodes of "
          f"the main sizes ({counts_hf['segment_scan']}) and K8 the "
          f"{short_hw[0]}x{short_hw[1]} one alone "
          f"({counts_hf['chase_starts_multi']})")
    check(np.array_equal(short_dev, short_host),
          f"{short_hw[0]}x{short_hw[1]}: scan='device' planes (K6 + K8) "
          "bit-equal to the host-scan path's")
    for (h, w), (blob, rec) in runs.items():
        cfg, data = container.read_data(blob)
        streams = (data.y, data.cb, data.cr)
        buf = torch.frombuffer(bytearray(b"".join(streams)),
                               dtype=torch.uint8).to(dev)
        ends = np.cumsum([len(s) for s in streams])
        st_hf, ok_hf = DS.scan_bands_starts(buf, ends, cfg.num_blocks, L)
        st_10, status_hf = DS.scan_bands_segmented(buf, ends, cfg.num_blocks,
                                                   L)
        check(bool(ok_hf) and DS.check_held(status_hf)
              and torch.equal(st_10, st_hf),
              f"{h}x{w}: the device scan accepts the stream, K10 with K8's "
              f"starts (status {status_hf.tolist()})")
    for (h, w), (blob, rec) in runs.items():
        check(np.array_equal(dev_recs[(h, w)], rec),
              f"{h}x{w}: scan='device' planes bit-equal to the host-scan "
              "path's")
        planes = dev_planes[(h, w)]
        check(planes.is_cuda and planes.shape == (3, h, w) and np.array_equal(
            planes.cpu().numpy().transpose(1, 2, 0), rec),
              f"{h}x{w}: decompress_to_device gives a CUDA tensor equal to "
              "them")
        cfg, data = container.read_data(blob)
        check(all(np.array_equal(got, native_codec.scan_offsets(
            s, cfg.num_blocks, L)) for got, s in zip(
                band_starts[(h, w)], (data.y, data.cb, data.cr))),
              f"{h}x{w}: entropy.scan_offsets(scan='device') gives each "
              "band's host C++ starts")
        im = images[(h, w)]
        want = [runs[(h, w)][0],
                compress_ycbcr(np.roll(im, 64, 1), cfg_for(h, w)),
                runs[(h, w)][0]]
        check(many_blobs[(h, w)] == want,
              f"{h}x{w}: compress_many containers byte-equal to "
              "compress_ycbcr's")
    for scan, recs in many.items():
        check(all(np.array_equal(r, runs[sizes[i % 2]][1])
                  for i, r in enumerate(recs)),
              f"decompress_many(scan={scan!r}) over mixed sizes equals the "
              "per-image results")
    check("host" in errors and errors.get("device") is errors["host"],
          f"a truncated container raises {errors['host'].__name__} with "
          "either scan")
    check(all(counts_hf[name] > 0 for name in HOST_FREE_PATH),
          "K6, K7, K8 and K10 were launched by the host-free run")
    hw = (2160, 3840)
    K.reset_launch_counts()
    auto_rec = decompress_to_ycbcr(runs[hw][0])
    counts_auto = K.launch_counts()
    check(counts_auto["segment_scan"] == 1
          and counts_auto["scan_walk"] == 0
          and counts_auto["chase_starts_multi"] == 0
          and counts_auto["decode_stream_blocks"] == 1,
          f"{hw[0]}x{hw[1]}: the default scan took the device scan (K10 "
          f"once, neither K6 nor K8, K3 once: {counts_auto})")
    check(np.array_equal(auto_rec, runs[hw][1]),
          f"{hw[0]}x{hw[1]}: the default scan's planes bit-equal to "
          "scan='host''s")

    log("== phase 4c: the BASELINE configurations (compress_ycbcr -> "
        "decompress_to_ycbcr, scan='host' and scan='device')")
    baseline_runs = {}
    k5_launches = 0
    k4_d24_launches = k1_l576_launches = 0
    for label, (h, w), bs, d, transform, (qname, qparams) in BASELINE:
        cfg = Configuration(width=w, height=h, block_size=bs, dct_size=d,
                            transform=transform,
                            quantization=QuantizationMethod(qname, **qparams))
        im = images[(h, w)] if (h, w) in images else synth_image(h, w)
        K.reset_launch_counts()
        blob = compress_ycbcr(im, cfg)
        rec = decompress_to_ycbcr(blob, scan="host")
        rec_dev = decompress_to_ycbcr(blob, scan="device")
        counts_c = K.launch_counts()
        baseline_runs[(label, h, w)] = (cfg, im, blob)
        log(f"  -- ({label}) {h}x{w}, bs {bs}, d {d}, {transform}, {qname} "
            f"{qparams or ''}: {len(blob)} bytes ({im.nbytes / len(blob):.2f}"
            f"x); launch counts {counts_c}")
        if label == "4b":
            k5_launches += counts_c["encode_blocks"]
        if label == "3":
            k4_d24_launches = counts_c["decode_blocks"]
            k1_l576_launches = counts_c["encode_stream_rows"]
        check((counts_c["encode_blocks"] > 0) == (label == "4b")
              and (counts_c["decode_blocks"] > 0) == (label != "5")
              and all(counts_c[n] > 0 for n in MAIN_PATH if n !=
                      "decode_blocks"),
              f"K5 launched {counts_c['encode_blocks']} times, K4 "
              f"{counts_c['decode_blocks']} (K5 only on DFT over ragged "
              "geometry, K4 wherever the dequantizer is an integer)")
        cfg2, data = container.read_data(blob)
        streams = [data.y, data.cb, data.cr]
        check(cfg2 == cfg, "container re-parses")
        img_t = torch.from_numpy(im).to(dev).permute(2, 0, 1)
        lv = BandEncoder(cfg).to(dev)(img_t).cpu().numpy()     # (3, N, L)
        check(all(native_codec.encode_levels(lv[b]) == streams[b]
                  for b in range(3)),
              "band streams byte-equal to the host C++ encoder's")
        flips_e = flips_d = 0
        for b in range(3):
            ref, ties = parity.encode_reference_and_ties(cfg, im[:, :, b])
            parity.assert_tie_equal(lv[b], ref, ties, f"levels band {b}")
            flips_e += int((lv[b] != ref).sum())
            pref, pties = parity.decode_reference_and_ties(cfg, lv[b])
            parity.assert_tie_equal(rec[:, :, b], pref, pties,
                                    f"planes band {b}")
            flips_d += int((rec[:, :, b] != pref).sum())
        check(True, f"levels and planes equal the f64 references except +-1 "
              f"at ties ({flips_e} level, {flips_d} pixel tie flips)")
        check(np.array_equal(rec, rec_dev),
              "scan='device' planes bit-equal to scan='host' planes")
        log(f"  PSNR {psnr(im, rec):.2f} dB")

    log("== phase 4d: the f64 parity mode on the card (the golden blobs)")
    gdir = os.path.join(REPO, "tests", "golden")
    with open(os.path.join(gdir, "manifest.json")) as f:
        manifest = json.load(f)
    K.reset_launch_counts()
    for name, entry in sorted(manifest.items()):
        kw = dict(entry["config"])
        q = kw.pop("quantization", None)
        cfg = Configuration(**kw, quantization=QuantizationMethod(
            q["name"], **q["params"]) if q else None)
        with open(os.path.join(gdir, f"{name}.jc"), "rb") as f:
            want = f.read()
        blob = compress_ycbcr(golden_image(cfg.height, cfg.width), cfg,
                              dtype=torch.float64)
        hashes = {hashlib.sha256(decompress_to_ycbcr(
            want, scan=scan, dtype=torch.float64).tobytes()).hexdigest()
            for scan in ("host", "device")}
        check(blob == want and hashes == {entry["decoded_sha256"]},
              f"{name}: the f64 encode is the golden blob byte for byte, and "
              "its decode (both scans) the recorded plane hash")
    log(f"  launch counts over the parity run: {K.launch_counts()}")

    log("== phase 4e: the tables encode, the two-sweep end table and the "
        "step pipeline")
    K.reset_launch_counts()
    tables_blobs = {hw: compress_ycbcr(images[hw], cfg_for(*hw), enc="tables")
                    for hw in sizes}
    counts_tb = K.launch_counts()
    log(f"  launch counts over the tables run: {counts_tb}")
    check(counts_tb["encode_stream_rows_tables"] == len(sizes)
          and counts_tb["encode_stream_rows"] == 0
          and all(counts_tb[n] > 0 for n in TABLES_PATH),
          f"enc='tables' launched K9 once per image and K1 never "
          f"({len(sizes)} images)")
    for hw, blob in tables_blobs.items():
        check(blob == runs[hw][0], f"{hw[0]}x{hw[1]}: the enc='tables' "
              "container is byte-equal to enc='lv''s")
    for hw in sizes:
        batch3 = [images[hw], np.roll(images[hw], 64, 1), images[hw]]
        check(compress_many(batch3, cfg_for(*hw), enc="tables")
              == [compress_ycbcr(x, cfg_for(*hw), enc="tables")
                  for x in batch3] == many_blobs[hw],
              f"{hw[0]}x{hw[1]}: compress_many(enc='tables') equals its "
              "per-image results and the lv containers")
    cfg24, im24, _ = baseline_runs[("3", *SIZES[0])]
    try:
        compress_ycbcr(im24, cfg24, enc="tables")
        raised = None
    except ValueError as e:
        raised = str(e)
    check(raised is not None and "L=576" in raised,
          f"enc='tables' at d = 24 raises ValueError ({raised})")

    main_streams = {}
    for hw, (blob, _) in runs.items():
        _, data = container.read_data(blob)
        raw = b"".join((data.y, data.cb, data.cr))
        main_streams[hw] = (DC.upload_stream(raw, dev), len(raw))
    single = {hw: DS.end_table(s, n, L) for hw, (s, n) in main_streams.items()}
    K.reset_launch_counts()
    two = {hw: DS.end_table(s, n, L, cap=12)
           for hw, (s, n) in main_streams.items()}
    counts_2s = K.launch_counts()
    log(f"  launch counts over the two-sweep run: {counts_2s}")
    check(all(torch.equal(two[hw], single[hw]) for hw in sizes)
          and counts_2s["scan_walk_capped"] == len(sizes)
          and counts_2s["scan_walk_resume"] == len(sizes)
          and counts_2s["scan_walk"] == 0,
          "end_table(cap=12) on both main-path streams: bit-equal to the "
          "single sweep, K6' launched twice per stream (each sweep once) "
          "and K6 never")

    from jpeg_tpu_torch import compress_band, decompress_band, steps
    h, w = SIZES[0]
    cfg = cfg_for(h, w)
    band_y = images[SIZES[0]][:, :, 0]
    steps_f64 = steps.compress_band_steps(band_y, cfg, dtype=torch.float64)
    check(steps_f64 == compress_band(band_y, cfg, dtype=torch.float64),
          f"f64 steps on the card, {h}x{w} Y band: bytes equal "
          "compress_band's (f64)")
    steps_f32 = steps.compress_band_steps(band_y, cfg)
    band_f32 = compress_band(band_y, cfg)
    nb, Lb = cfg.num_blocks, cfg.dct_size ** 2
    lv_s = native_codec.decode_levels(steps_f32, nb, Lb)
    lv_b = native_codec.decode_levels(band_f32, nb, Lb)
    ref, ties = parity.encode_reference_and_ties(cfg, band_y)
    parity.assert_tie_equal(lv_s, ref, ties, "f32 steps levels vs f64")
    parity.assert_tie_equal(lv_s, lv_b, ties, "f32 steps levels vs band")
    check(True, f"f32 steps on the card: levels equal compress_band's "
          f"except +-1 at ties ({int((lv_s != lv_b).sum())} flips; bytes "
          f"{'equal' if steps_f32 == band_f32 else 'differ at those ties'})")
    plane_s = steps.decompress_band_steps(band_f32, cfg)
    plane_b = decompress_band(band_f32, cfg)
    _, pties = parity.decode_reference_and_ties(cfg, lv_b)
    parity.assert_tie_equal(plane_s, plane_b, pties, "f32 steps plane")
    plane_64 = steps.decompress_band_steps(steps_f64, cfg,
                                           dtype=torch.float64)
    check(np.array_equal(plane_64, decompress_band(steps_f64, cfg,
                                                   dtype=torch.float64)),
          f"decompress_band_steps on the card: f32 plane equals "
          f"decompress_band's except +-1 at ties "
          f"({int((plane_s != plane_b).sum())} flips), f64 plane equal")
    for gname, entry in sorted(manifest.items()):
        kw = dict(entry["config"])
        q = kw.pop("quantization", None)
        gcfg = Configuration(**kw, quantization=QuantizationMethod(
            q["name"], **q["params"]) if q else None)
        with open(os.path.join(gdir, f"{gname}.jc"), "rb") as f:
            _, gdata = container.read_data(f.read())
        gimg = golden_image(gcfg.height, gcfg.width)
        check(steps.compress_band_steps(gimg[:, :, 0], gcfg,
                                        dtype=torch.float64) == gdata.y,
              f"f64 steps on the card: {gname}'s Y band bytes")

    log("== phase 4f: the parallel layer, the CLI and the profiling module")
    batch_launches = parallel_phase(dev, card)

    log("== phase 4g: the on-device test suite (gpu_tests/)")
    gpu_tests_phase(card)

    log(f"== phase 5: timing (CUDA events; {card})")
    for (h, w), (blob, _) in runs.items():
        cfg = cfg_for(h, w)
        im = images[(h, w)]
        enc = median_call_ms(lambda: compress_ycbcr(im, cfg), REPS)
        mp = h * w / 1e6
        log(f"  encode {h}x{w}: {enc:.3f} ms median of {REPS} "
            f"= {mp / enc * 1e3:.1f} MP/s  [{card}]")
        for scan in ("host", "device", "host", "device"):
            dec_ms = median_call_ms(
                lambda: decompress_to_ycbcr(blob, scan=scan), REPS)
            log(f"  decode {h}x{w} scan={scan}: {dec_ms:.3f} ms median of "
                f"{REPS} = {mp / dec_ms * 1e3:.1f} MP/s  [{card}]")
    log("  -- encode by stage (each stage ended by a device sync, host "
        f"clock, median of {REPS})")
    enc_staged = [(f"{h}x{w}", cfg_for(h, w), images[(h, w)], blob)
                  for (h, w), (blob, _) in runs.items()]
    enc_staged += [(f"({label}) {h}x{w}", cfg_b, im_b, blob_b)
                   for (label, h, w), (cfg_b, im_b, blob_b)
                   in baseline_runs.items()
                   if label == "4b" and (h, w) == SIZES[0]]
    for tag, cfg, im, blob in enc_staged:
        stages = {}

        def stage(name, fn):
            def run():
                out = fn()
                torch.cuda.synchronize()
                return out
            out = run()
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            stages[name] = float(np.median(times))
            return out

        img_d = stage("upload image", lambda: torch.from_numpy(im).to(dev))
        benc = BandEncoder(cfg).to(dev)
        lv_s = stage("transform", lambda: benc(img_d.permute(2, 0, 1)))
        flat_s = lv_s.reshape(-1, lv_s.shape[-1])

        def stats():
            bb = DC.block_bytes_of(flat_s).to(torch.int64)
            st = torch.stack([bb.max(), bb.sum(), flat_s.abs().max()])
            return [int(x) for x in st.cpu()]

        max_bb, total_s, _ = stage("phase-1 stats + pull", stats)
        buf_s = stage("K1 + K2", lambda: DC.encode_stream_sized(
            flat_s, -(-max_bb // 4), total_s)[0])
        raw_s = stage("download stream", lambda: buf_s.cpu().numpy().tobytes())
        _, data_s = container.read_data(blob)
        stage("container pack", lambda: container.generate_data(cfg, data_s))
        check(raw_s == b"".join((data_s.y, data_s.cb, data_s.cr)),
              f"{tag}: the staged encode's stream is the container's")
        log(f"  {tag}: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in stages.items())
            + f"; sum {sum(stages.values()):.3f} ms  [{card}]")
    log("  -- host-free decode by stage (each stage ended by a device "
        f"sync, host clock, median of {REPS})")
    staged = [(f"{h}x{w}", blob) for (h, w), (blob, _) in runs.items()]
    staged += [(f"({label}) {h}x{w}", blob)
               for (label, h, w), (_, _, blob) in baseline_runs.items()
               if label in ("3", "4b") and (h, w) == SIZES[0]]
    for tag, blob in staged:
        stages = {}

        def stage(name, fn):
            def run():
                out = fn()
                torch.cuda.synchronize()
                return out
            out = run()
            times = []
            for _ in range(REPS):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            stages[name] = float(np.median(times))
            return out

        cfg, data = stage("parse container",
                          lambda: container.read_data(blob))
        streams = [data.y, data.cb, data.cr]
        nbh, Lc = cfg.num_blocks, cfg.dct_size ** 2
        ends = np.cumsum([len(x) for x in streams]).tolist()
        stream = stage("upload stream", lambda: DC.upload_stream(
            b"".join(streams), dev))
        if DS.segmented(nbh):
            starts, status = stage(
                "K10 segmented scan", lambda: K.segment_scan(
                    stream, [0] + ends[:-1], ends, nbh, Lc))
            stage("check pull", lambda: DS.check_held(status))
        else:
            E = stage("K6 end table",
                      lambda: DS.end_table(stream, ends[-1], Lc))
            tg = torch.tensor(ends, dtype=torch.int64, device=dev)
            s0 = torch.tensor([0] + ends[:-1], dtype=torch.int64, device=dev)
            starts, oks = stage("K8 chase", lambda: K.chase_starts_multi(
                E, tg, s0, nbh))
            stage("check pull", lambda: bool(oks.all()))
        levels = stage("K3 levels", lambda: DC.decode_stream(
            stream, starts.reshape(-1), Lc))
        bdec = stage("BandDecoder build", lambda: BandDecoder(cfg).to(dev))
        planes = stage("K4 + layout", lambda: bdec(levels.reshape(3, nbh,
                                                                  Lc)))
        stage("download planes",
              lambda: planes.cpu().numpy().transpose(1, 2, 0))
        total = median_call_ms(
            lambda: decompress_to_ycbcr(blob, scan="device"), REPS)
        log(f"  {tag}: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in stages.items())
            + f"; sum {sum(stages.values()):.3f} ms, unfenced call "
            f"{total:.3f} ms  [{card}]")

    # Launches on the run of the path each kernel belongs to (counts reset
    # just before it): the main path, the host-free path, the BASELINE (4b)
    # runs, the tables run and the two-sweep run.
    launches_of = dict(counts)
    launches_of.update({n: counts_hf[n] for n in HOST_FREE_PATH})
    launches_of["encode_blocks"] = k5_launches
    launches_of["encode_stream_rows_tables"] = counts_tb[
        "encode_stream_rows_tables"]
    launches_of.update({n: counts_2s[n] for n in ("scan_walk_capped",
                                                  "scan_walk_resume")})
    launches_of[K4_D24] = k4_d24_launches
    launches_of[K1_L576] = k1_l576_launches
    kernels = []
    for name, r in results.items():
        ms = time_ms(r["fn"], 50)
        plain_ms = time_ms(r["plain"], r.get("plain_reps", 5))
        # One PyTorch call computes K4's and K5's product without their
        # epilogues: a full-f32 torch.matmul of the same operands.  None
        # computes the others (a bit writer, a byte-offset scatter, a bit
        # parser, a walker, a pointer chase): library_ms is null.
        library_ms = time_ms(r["library"], 10) if "library" in r else None
        bound_ms, bound_by = bound(r["nbytes"], r.get("flops", 0),
                                   r.get("rate", F32_FLOP_PER_S))
        shape = r.get("shape", f"N={n_blocks}, L={L}, stream {img_ends[-1]} "
                      "bytes")
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            + (f"torch.matmul {library_ms:.4f} ms, " if library_ms else "")
            + f"bound {bound_ms:.4f} ms by {bound_by} ({shape})  [{card}]")
        src, repl = KERNEL_INFO[name.split("[")[0]]
        err = scan_err[name] if name in scan_err else r["err"]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": repl, "launches": launches_of[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms}
        if "error_eps32" in r:
            entry["error_eps32"] = r["error_eps32"]
        if name in batch_launches:
            entry["launches_batch"] = batch_launches[name]
        kernels.append(entry)
    log(f"  encode_blocks' product without its epilogue "
        f"(encode_blocks_sums, f32 out, uncounted): "
        f"{time_ms(k5_product, 50):.4f} ms  [{card}]")
    log(f"  _unit_groups (the tables K9 reads, torch ops): "
        f"{time_ms(unit_groups_fn, 50):.4f} ms (N={n_blocks}, L={L})  "
        f"[{card}]")

    log("  -- K8's device kernels on the main-path streams; K7 / K8 in both "
        "forms around CHASE_DIRECT_MAX (mean of 50 launches)")
    for (h, w), (blob, _) in runs.items():
        cfg, data = container.read_data(blob)
        s, n = main_streams[(h, w)]
        nbh = cfg.num_blocks
        ends_h = np.cumsum([len(data.y), len(data.cb), len(data.cr)]).tolist()
        tg = torch.tensor(ends_h, dtype=torch.int64, device=dev)
        s0 = torch.tensor([0] + ends_h[:-1], dtype=torch.int64, device=dev)
        E_h = K.scan_walk(s, n, L)
        jumps = K.chase_plan(E_h.shape[0], 3, nbh).anchors - 1
        log(f"  K8 {h}x{w}, nb = {nbh} ({jumps} serial jumps of E^"
            f"{K.CHASE_JUMP}, then {K.CHASE_JUMP} fill steps a band): "
            + device_kernels(lambda: K.chase_starts_multi(E_h, tg, s0,
                                                          nbh))[2]
            + f"  [{card}]")
        log(f"  K10 {h}x{w}, nb = {nbh}, {K.SEGMENT_BYTES}-byte segments: "
            + device_kernels(lambda: K.segment_scan(
                s, [0] + ends_h[:-1], ends_h, nbh, L))[2] + f"  [{card}]")
    # The selection: three-band prefixes of the 2048x2048 stream, nb blocks
    # a band, both forms (uncounted launches).
    cfg, data = container.read_data(runs[SIZES[0]][0])
    bands0 = [data.y, data.cb, data.cr]
    st0 = [native_codec.scan_offsets(b, cfg.num_blocks, L) for b in bands0]
    for nb_x in (dmax // 2, dmax, 2 * dmax, 4 * dmax):
        parts = [b[:int(st[nb_x])] for b, st in zip(bands0, st0)]
        raw_x = b"".join(parts)
        buf_x = torch.frombuffer(bytearray(raw_x), dtype=torch.uint8).to(dev)
        ends_x = np.cumsum([len(p) for p in parts]).tolist()
        tg_x = torch.tensor(ends_x, dtype=torch.int64, device=dev)
        s0_x = torch.tensor([0] + ends_x[:-1], dtype=torch.int64, device=dev)
        E_x = K.scan_walk(buf_x, len(raw_x), L)
        row = []
        for name, plan in forms(E_x.shape[0], 3, nb_x):
            ms8 = time_ms(lambda: K._chase(E_x, nb_x, tg_x, s0_x, plan), 50)
            plan7 = forms(E_x.shape[0], 1, nb_x)[name == "long"][1]
            ms7 = time_ms(lambda: K._chase(E_x, nb_x, ends_x[0], 0, plan7),
                          50)
            row.append(f"{name} form K8 {ms8:.4f} ms, K7 {ms7:.4f} ms")
        pick = "short" if K.chase_plan(1, 3, nb_x).anchors == 0 else "long"
        log(f"  nb = {nb_x} ({len(raw_x)} bytes): " + "; ".join(row)
            + f" (the plan takes the {pick} form)  [{card}]")
    s, n = main_streams[SIZES[0]]
    plan0 = K.scan_walk_plan(n, L, sms)
    units = walk_units(s, n, L)
    before = warp_max_units(units)
    total_units = int(units.sum())
    log(f"  K6 work on the {SIZES[0][0]}x{SIZES[0][1]} stream ({n} bytes, "
        f"{n} walkers): {total_units} units walked, {int(units.max())} at "
        f"most; sum over warps of the slowest lane's units: {before} with "
        f"one walker per thread ({total_units / (32 * before):.3f} of "
        "the lane slots walk)")
    for pr in (1, K.SCAN_UNITS_PER_ROUND):
        rounds = int(refill_rounds(units, plan0.tile, K.SCAN_THREADS,
                                   pr).sum())
        log(f"    refilled lanes, tiles of {plan0.tile}, rounds of up to {pr} "
            f"units (modelled): {rounds} warp rounds = {rounds * pr} unit slots "
            f"({total_units / (32 * rounds * pr):.3f} of the lane slots "
            "walk)")

    log("  -- boundary scan of one band by stream size: pure-Python scanner, "
        "C++ scanner, device scan (K6 + K7, upload and pull included)")
    big_blob = runs[sizes[-1]][0]
    big_cfg, big_data = container.read_data(big_blob)
    band = big_data.y
    starts0 = native_codec.scan_offsets(band, big_cfg.num_blocks, L)
    block_ends = np.append(starts0[1:], len(band))
    crossover = None
    for size in CROSSOVER_BYTES:
        k = min(int(np.searchsorted(block_ends, size)) + 1, len(block_ends))
        part = band[:int(block_ends[k - 1])]
        py_ms = median_host_ms(lambda: numpy_codec.scan_offsets(part, k, L),
                               3)
        cpp_ms = median_host_ms(lambda: native_codec.scan_offsets(part, k, L),
                                REPS)
        dev_ms = median_host_ms(
            lambda: DS.scan_offsets_device(part, k, L), REPS)
        if crossover is None and dev_ms < py_ms:
            crossover = len(part)
        log(f"  scan {len(part)} bytes ({k} blocks): python {py_ms:.3f} ms, "
            f"C++ {cpp_ms:.3f} ms, device {dev_ms:.3f} ms  [{card}]")
    log(f"  the device scan overtakes the pure-Python scanner by "
        f"{crossover} bytes (PY_SCAN_DEVICE_MIN_BYTES = "
        f"{DS.PY_SCAN_DEVICE_MIN_BYTES})  [{card}]")

    log(f"  -- {MANY} images of {sizes[0][0]}x{sizes[0][1]}, depth 2")
    h, w = sizes[0]
    cfg = cfg_for(h, w)
    batch = [np.roll(images[(h, w)], 64 * i, 1) for i in range(MANY)]
    blobs = compress_many(batch, cfg)
    check(blobs == [compress_ycbcr(im, cfg) for im in batch],
          f"compress_many over {MANY} images equals compress_ycbcr")
    mp = MANY * h * w / 1e6
    for label, fn in (
            ("compress_ycbcr loop", lambda: [compress_ycbcr(im, cfg)
                                             for im in batch]),
            ("compress_many", lambda: compress_many(batch, cfg, depth=2)),
            ("decompress_to_ycbcr loop scan=host",
             lambda: [decompress_to_ycbcr(b, scan="host") for b in blobs]),
            ("decompress_many scan=host",
             lambda: decompress_many(blobs, scan="host", depth=2)),
            ("decompress_to_ycbcr loop scan=device",
             lambda: [decompress_to_ycbcr(b, scan="device") for b in blobs]),
            ("decompress_many scan=device",
             lambda: decompress_many(blobs, scan="device", depth=2))):
        ms = median_host_ms(fn, 3)
        log(f"  {label}: {ms:.3f} ms median of 3 = {mp / ms * 1e3:.1f} "
            f"MP/s  [{card}]")
    log("  -- BASELINE configurations host->host (CUDA events, median of "
        f"{REPS})")
    for (label, h, w), (cfg, im, blob) in baseline_runs.items():
        if label not in TIMED_BASELINE:
            continue
        mp = h * w / 1e6
        enc = median_call_ms(lambda: compress_ycbcr(im, cfg), REPS)
        line = (f"  ({label}) {h}x{w}: encode {enc:.3f} ms = "
                f"{mp / enc * 1e3:.1f} MP/s")
        for scan in ("host", "device"):
            dec_ms = median_call_ms(
                lambda: decompress_to_ycbcr(blob, scan=scan), REPS)
            line += (f"; decode scan={scan} {dec_ms:.3f} ms = "
                     f"{mp / dec_ms * 1e3:.1f} MP/s")
        log(line + f"  [{card}]")
    log(f"  -- encode host->host, enc='lv' and enc='tables' in turns "
        f"(CUDA events, median of {REPS})")
    for hw in sizes:
        cfg, im = cfg_for(*hw), images[hw]
        mp = hw[0] * hw[1] / 1e6
        turns = []
        for enc_name in ("lv", "tables", "lv", "tables"):
            ms = median_call_ms(lambda: compress_ycbcr(im, cfg, enc=enc_name),
                                REPS)
            turns.append(f"{enc_name} {ms:.3f} ms = {mp / ms * 1e3:.1f} MP/s")
        log(f"  {hw[0]}x{hw[1]}: " + "; ".join(turns) + f"  [{card}]")
    log("  -- end table: single sweep (K6) and two sweeps (K6' twice: "
        "sweep 1 appends its survivors to a list on the device, sweep 2 "
        "resumes them), mean of 50 back-to-back calls")
    for hw, (s, n) in main_streams.items():
        parts = [f"single {time_ms(lambda: DS.end_table(s, n, L), 50):.4f} ms"]
        for cap in TWO_SWEEP_CAPS:
            live = int(K.scan_walk_capped(s, n, L, cap)[1].n[0])
            ms = time_ms(lambda: DS.end_table(s, n, L, cap=cap), 50)
            parts.append(f"cap {cap} {ms:.4f} ms ({live} resumed)")
        parts.append(f"single {time_ms(lambda: DS.end_table(s, n, L), 50):.4f}"
                     " ms")
        log(f"  {hw[0]}x{hw[1]} stream, {n} bytes: " + "; ".join(parts)
            + f"  [{card}]")
    log("  -- device kernels of one call (torch.profiler CUDA events)")
    rows_k2, bb_k2 = K.encode_stream_rows(
        flat, -(-int(DC.block_bytes_of(flat).max()) // 4))
    total_k2 = int(bb_k2.to(torch.int64).sum())
    k2_count, _, k2_kernels = device_kernels(
        lambda: K.deposit_rows(rows_k2, bb_k2, total_k2))
    log(f"  deposit_rows, {SIZES[0][0]}x{SIZES[0][1]} ({total_k2} bytes): "
        f"{k2_kernels}  [{card}]")
    check(k2_count <= 2,
          "one deposit_rows call runs at most two device kernels (no "
          "memset, cast or cumsum)")
    k3_count, _, k3_kernels = device_kernels(
        lambda: K.decode_stream_blocks(img_buf, img_starts, L))
    log(f"  decode_stream_blocks, {SIZES[0][0]}x{SIZES[0][1]}: {k3_kernels}  "
        f"[{card}]")
    check(k3_count <= 1, "one decode_stream_blocks call runs at most one "
          "device kernel (no memset)")
    s, n = main_streams[SIZES[0]]
    W = -(-int(DC.block_bytes_of(flat).max()) // 4)
    for label, fn in (
            ("end_table(cap=0)", lambda: DS.end_table(s, n, L)),
            ("encode_rows(enc='lv')", lambda: DC.encode_rows(flat, W)),
            ("encode_rows(enc='tables')",
             lambda: DC.encode_rows(flat, W, enc="tables"))):
        log(f"  {label}, {SIZES[0][0]}x{SIZES[0][1]}: "
            f"{device_kernels(fn)[2]}  [{card}]")
    for hw, (s2, n2) in main_streams.items():
        agg = device_events(lambda: DS.end_table(s2, n2, L, cap=12))
        count_2s, _, text_2s = device_kernels(None, agg=agg)
        memsets = sum(c for name, (_, c) in agg.items()
                      if "memset" in name.lower())
        log(f"  end_table(cap=12), {hw[0]}x{hw[1]}: {text_2s}  [{card}]")
        check(count_2s - memsets <= 2 and memsets <= 1,
              f"one end_table(cap=12) call runs at most two device kernels "
              f"({count_2s - memsets}) and one memset ({memsets}), "
              f"{hw[0]}x{hw[1]}")
    for name in ("encode_stream_rows", "encode_stream_rows_tables", K1_L576):
        count_w, _, text_w = device_kernels(results[name]["fn"])
        log(f"  {name} ({results[name].get('shape', 'main path')}): "
            f"{text_w}  [{card}]")
        check(count_w <= 1, f"one {name} call runs at most one device "
              "kernel (no memset)")
    # One call's device time, after the last profiler session: in some runs
    # a session that followed other work (a session in phase 3, graph
    # captures) lost the kernels launched through ctypes.
    log("  -- one call's device time (CUDA graph of 20 calls, replayed): "
        "back-to-back wrapper calls can be bound by the wrappers' host work")
    by_name = {e["name"]: e for e in kernels}
    for name in DEVICE_TIMED:
        ms_d = graph_ms(results[name]["fn"])
        if ms_d is not None:
            by_name[name]["device_ms"] = ms_d
        log(f"  {name}: " + (f"{ms_d:.4f} ms" if ms_d else "not measured")
            + f"  [{card}]")
    ms_d = graph_ms(k5_product)
    log("  encode_blocks' product without its epilogue (encode_blocks_sums): "
        + (f"{ms_d:.4f} ms" if ms_d else "not measured") + f"  [{card}]")
    ms_d = graph_ms(lambda: K.scan_walk_resume(img_buf, P_img, L, q_img, 12))
    b21 = bound(21 * P_img)[0]
    log("  scan_walk_resume's list form, q = every byte of the "
        f"{P_img}-byte stream, cap 12 (the K6' row's work before the "
        "two-sweep table had kernels of its own): "
        + (f"{ms_d:.4f} ms, " if ms_d else "not measured, ")
        + f"bound {b21:.4f} ms (21 bytes a walker: its stream byte, q, and "
        "three int32 out)" + (f", {100 * b21 / ms_d:.1f} % of it"
                              if ms_d else "") + f"  [{card}]")

    def fmt(ms):
        return f"{ms:.4f}" if ms is not None else "not measured"

    log("  -- the end table's device time, one call (CUDA graph of 20 calls, "
        "replayed), ms: single sweep (K6) and two sweeps (K6' twice), each "
        "sweep alone, the survivors; sweep 2 on grids of "
        f"{K6R_EIGHTHS} eighths of a wave (K.SCAN_RESUME_EIGHTHS; the "
        f"plan's, {K.SCAN_RESUME_EIGHTHS}, marked *); K6's bound is P bytes "
        "in and 4(P + 2) out at 3.35 TB/s")
    plan_eighths = K.SCAN_RESUME_EIGHTHS
    for hw, (s2, n2) in main_streams.items():
        P2 = s2.shape[0]
        budget = K._walk_units(L)
        E_one = DS.end_table(s2, n2, L)
        same = True
        parts = ["single "
                 + fmt(graph_ms(lambda: DS.end_table(s2, n2, L)))]
        for cap in TWO_SWEEP_CAPS:
            E_c, surv = K.scan_walk_capped(s2, n2, L, cap)
            k = int(surv.n[0])
            two = graph_ms(lambda: DS.end_table(s2, n2, L, cap=cap))
            one = graph_ms(lambda: K.scan_walk_capped(s2, n2, L, cap))
            grids = []
            try:
                for eighths in K6R_EIGHTHS:
                    K.SCAN_RESUME_EIGHTHS = eighths
                    E_t = E_c.clone()
                    K.scan_walk_resume(s2, n2, L, surv.q, budget - cap,
                                       surv.c, surv.w, surv.n, table=E_t)
                    same &= torch.equal(E_t, E_one)
                    ms_g = graph_ms(lambda: K.scan_walk_resume(
                        s2, n2, L, surv.q, budget - cap, surv.c, surv.w,
                        surv.n, table=E_t))
                    grids.append(f"{eighths}/8"
                                 + ("*" if eighths == plan_eighths else "")
                                 + f" {fmt(ms_g)}")
            finally:
                K.SCAN_RESUME_EIGHTHS = plan_eighths
            parts.append(f"cap {cap} {fmt(two)} (sweep 1 {fmt(one)}, sweep 2 "
                         + ", ".join(grids) + f"; {k} survivors, "
                         f"{100 * k / P2:.2f} % of the bytes)")
        parts.append("single "
                     + fmt(graph_ms(lambda: DS.end_table(s2, n2, L))))
        log(f"  {hw[0]}x{hw[1]} stream, {n2} bytes: " + "; ".join(parts)
            + f"; bound {bound(n2 + 4 * (n2 + 2))[0]:.4f}  [{card}]")
        check(same, f"  sweep 2 on every grid, {hw[0]}x{hw[1]}: the single "
              "sweep's table")
    log("  -- K1 and K9 by plan (uncounted launches, one call's device "
        "time, ms): for each group size of K.ENC_LANES the fastest of its "
        "tiles (half, once and twice ENC_THREADS threads' worth, and the "
        "plan's); every plan's rows (K1: and block bytes) checked "
        "bit-equal to the plan's, and the plan's to the plain version's "
        "where L <= 256 (phase 3 holds L = 576 and 1,024)")
    cfg_sweep = {"1": (4, 8, "none", {}), "2": (5, 8, "qtable", {}),
                 "3": (4, 24, "divide", {"divisor": 1000})}
    img_s = torch.from_numpy(images[SIZES[0]]).to(dev).permute(2, 0, 1)

    def sweep_levels(bs, d, qname, qparams):
        cfg_s = Configuration(width=SIZES[0][1], height=SIZES[0][0],
                              block_size=bs, dct_size=d,
                              quantization=QuantizationMethod(qname,
                                                              **qparams))
        return BandEncoder(cfg_s).to(dev)(img_s).reshape(-1, d * d)

    # The main path's levels and prefixes of them, BASELINE (1), (2) and
    # (3) repeated to more blocks, and d = 3, 16 and 32 at several block
    # sizes (the points encode_rows_plan's thresholds were fitted to).
    sweep_sets = [(f"main, first {m}", flat[:m]) for m in
                  (1452, 3072, 6144, 12288, 16384, 24576, 32768)]
    sweep_sets.append(("main", flat))
    for label_b in ("1", "2", "3"):
        lv_b = sweep_levels(*cfg_sweep[label_b])
        for k in ((1, 2, 4) if label_b != "3" else (1, 2, 4, 8, 16, 32)):
            sweep_sets.append((f"BASELINE ({label_b}) x {k}",
                               lv_b.repeat(k, 1)))
    for bs, d in ((2, 3), (1, 16), (2, 16), (4, 16), (8, 16), (1, 32),
                  (2, 32), (4, 32)):
        sweep_sets.append((f"bs {bs}, d {d}", sweep_levels(
            bs, d, *(("none", {}) if d == 3
                     else ("divide", {"divisor": 1000})))))
    sweep_rows = []
    for label_s, lv_s in sweep_sets:
        lv_s = lv_s.contiguous()
        n_s, L_s = lv_s.shape
        W_s = -(-int(DC.block_bytes_of(lv_s).max()) // 4)
        sweep_rows.append((
            f"K1 {label_s}", n_s, L_s, W_s, 1,
            lambda p, lv=lv_s, w=W_s: K._encode_rows(lv, w, p),
            lambda lv=lv_s, w=W_s: K.encode_stream_rows_plain(lv, w)))
        if L_s <= DC.TABLES_MAX_L:
            cb_s, vh_s, vl_s, _ = DC._unit_groups(lv_s)
            sweep_rows.append((
                f"K9 {label_s}", n_s, L_s + 1, W_s, 2,
                lambda p, c=cb_s, hi=vh_s, lo=vl_s, w=W_s:
                K._encode_tables(c, hi, lo, w, p),
                lambda c=cb_s, hi=vh_s, lo=vl_s, w=W_s:
                K.encode_stream_rows_tables_plain(c, hi, lo, w)))
    losses = []
    for label, n_w, S_w, W_w, tables_w, run, plain_w in sweep_rows:
        plan_w = K.encode_rows_plan(n_w, S_w, W_w, sms, tables_w)
        out_plan = run(plan_w)
        same = S_w > 257 or outputs_equal(out_plan, plain_w())
        by_lanes = {}
        for lanes in K.ENC_LANES:
            base = max(K.ENC_THREADS // lanes, 1)
            tiles = {base // 2, base, 2 * base}
            if plan_w.lanes == lanes:
                tiles.add(plan_w.tile)
            for tile in sorted(tiles):
                p_w = K.EncodeRowsPlan(lanes, tile, W_w <= K.ENC_ROW_MAX_WORDS)
                if (tile < 1 or tile * lanes < 32
                        or (lanes == 1 and tile > K.ENC_THREADS)
                        or K.encode_rows_smem(S_w, W_w, p_w, tables_w)
                        > K.ENC_MAX_SMEM):
                    continue
                same = same and outputs_equal(run(p_w), out_plan)
                ms_w = graph_ms(lambda p=p_w, f=run: f(p))
                if ms_w is not None:
                    by_lanes[(lanes, tile)] = ms_w
        check(same, f"{label} (N = {n_w}, L = {S_w - tables_w + 1}): every "
              "plan's rows bit-equal to the plan's"
              + (", the plan's to the plain version's" if S_w <= 257
                 else ""))
        if not by_lanes:
            continue
        best = {}
        for (lanes, tile), ms_w in by_lanes.items():
            if lanes not in best or ms_w < best[lanes][1]:
                best[lanes] = (tile, ms_w)
        fastest = min(by_lanes.values())
        ms_plan = by_lanes.get(tuple(plan_w[:2]))
        if ms_plan is not None:
            losses.append(ms_plan / fastest - 1)
        log(f"  {label} (N = {n_w}, L = {S_w - tables_w + 1}, W = {W_w}): "
            + "; ".join(f"{g} lanes (tile {t}) {ms_g:.4f}"
                        for g, (t, ms_g) in best.items())
            + f"; the plan {tuple(plan_w)} "
            + (f"{ms_plan:.4f}, {100 * (ms_plan / fastest - 1):.1f} % over "
               "the fastest" if ms_plan is not None else "not measured")
            + f"  [{card}]")
    if losses:
        log(f"  the plan over the fastest plan at {len(losses)} points: "
            f"at most {100 * max(losses):.1f} %, mean "
            f"{100 * sum(losses) / len(losses):.1f} %  [{card}]")
    log("  -- K1's wrapper on the host (2048x2048 main path; median of "
        "2,000 calls, host clock, the queue drained every 100 calls): the "
        "wrapper, the launch with its plan (the wrapper less its checks, "
        "plan and count), the plan (cached), the SM count")
    plan_m = K.encode_rows_plan(n_blocks, L, W, sms)
    for label, fn in (
            ("encode_stream_rows", lambda: K.encode_stream_rows(flat, W)),
            ("_encode_rows(plan)", lambda: K._encode_rows(flat, W, plan_m)),
            ("encode_rows_plan", lambda: K.encode_rows_plan(
                n_blocks, L, W, sms)),
            ("_multiprocessors", lambda: K._multiprocessors(dev))):
        log(f"  {label}: {host_us(fn):.2f} us  [{card}]")
    log("  -- K3 at other tiles than its plan's (uncounted launches): the "
        "2048x2048 stream at L = 64 and BASELINE (3)'s d = 24 stream at "
        "L = 576")
    for label, (buf_t, st_t, L_t) in k3_streams.items():
        plan_t = K.decode_stream_plan(L_t)
        row = []
        for tile_t in sorted({min(max(plan_t.tile * m // 4, 1),
                                  K.DECODE_TILE_MAX)
                              for m in (1, 2, 4, 8, 16)}):
            p_t = plan_t._replace(tile=tile_t)
            ms_t = graph_ms(lambda: K._decode_stream(buf_t, st_t, L_t, p_t))
            row.append(f"tile {tile_t} " + (f"{ms_t:.4f} ms" if ms_t
                                            else "not measured"))
        log(f"  {label}: " + "; ".join(row) + f" (the plan's: "
            f"{plan_t.tile})  [{card}]")
    h, w = SIZES[0]
    log(f"  -- step pipeline, {h}x{w} Y band at the main configuration "
        f"(host clock, median of 3)")
    cfg = cfg_for(h, w)
    for label, fn in (
            ("compress_band_steps", lambda: steps.compress_band_steps(
                band_y, cfg)),
            ("compress_band", lambda: compress_band(band_y, cfg)),
            ("decompress_band_steps", lambda: steps.decompress_band_steps(
                band_f32, cfg)),
            ("decompress_band", lambda: decompress_band(band_f32, cfg))):
        log(f"  {label}: {median_host_ms(fn, 3):.3f} ms  [{card}]")
    log("  after timing: " + nvidia_smi(
        "clocks.sm,power.draw,power.limit,temperature.gpu"))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-child"]:
        sys.exit(gloo_child(int(sys.argv[2]), int(sys.argv[3]),
                            int(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
