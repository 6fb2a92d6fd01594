// SAME-padded 3x3 convolution, NHWC x HWIO -> NHWC, with an optional bias:
//
//   y[b, i, j, o] = bias[o] + sum_{dy, dx, c} x[b, i+dy-1, j+dx-1, c] w[dy, dx, c, o]
//
// (x is zero outside each image), accumulated in fp32, the bias added in
// fp32, and the sum rounded once to the storage dtype.  The weights are read
// in the HWIO [3, 3, C, O] layout the checkpoints hold, with no relayout per
// call.  Two entry points:
//
// rr_conv3x3 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_implicit_gemm
// (nine accumulated [tile_h W, C] x [C, O] MXU products over a halo'd row
// slab): any C, any O.
// rr_conv3x3_c64 replaces rerevst_tpu/kernels/conv3x3.py:conv3x3_pairlane,
// the same function for C = 64, O <= 64 (the full-resolution 64-channel
// layers: encoder conv1_2, decoder res2.conv2 and the 64->3 out conv).  The
// TPU kernel's lane pairing of two W-adjacent pixels only fills the MXU's
// 128 lanes and has no counterpart here.
//
// Which design takes which call (by shape, in the launcher; no switch):
// * 16-bit (f16, bf16) with C = 64 -- both entry points, every O: the
//   streamed design below (conv3x3_stream_kernel).
// * 16-bit with C % 64 = 0, C >= 128 and O > kSlicedMaxO = 64 -- rr_conv3x3
//   (VGG conv2_2 to conv4_1, the decoder's res3/res4 convs): the wide
//   design below (conv3x3_wide_kernel).
// * 16-bit with 1 <= C <= 7 -- rr_conv3x3 only (VGG's conv1_1 with C = 3,
//   whose 6-byte pixel stride no tensor map takes): the narrow design below
//   (conv3x3_narrow_kernel).
// * 16-bit with any other C >= 8 -- rr_conv3x3 only (C = 8, 32, 96, 100,
//   160, 200, ...: C that fills no 64-channel slice; and C % 64 = 0, C >=
//   128 with O <= kSlicedMaxO, such as the decoder filter blocks' `down`
//   conv 512 -> 32): the sliced design below (conv3x3_sliced_kernel).
// * fp32 with O > 32 -- both entry points, every C: at passes = 3 the
//   split-TF32 design below (conv3x3_tf32x3_kernel, N = 64), fp32-accurate
//   products on the tensor cores (the counterpart of the JAX package's
//   HIGHEST and HIGH precisions); at passes = 1, one TF32 pass (x and w
//   rounded to nearest TF32: the 'default' precision), the one-pass design
//   below (conv3x3_tf32x1_kernel: the weights as wgmma's A; the wrapper
//   passes R > 0).  fp32 calls with O <= 32, at either pass count, take
//   the rows design (csrc/conv3x3_rows.cu, rr_conv3x3_rows).
// No call reaches a cp.async + mma.sync kernel or the CUDA cores' FMAs.
// A tensor map that cannot be encoded or a refused launch is returned as
// an error: nothing retries on another design.
//
// What bounds the C = 64 convs on the H100 (989 TFLOP/s dense f16/bf16,
// 3.35 TB/s): at 64 -> 64 a pixel costs 2 x 576 x 64 = 73.7 kflop against
// 256 bytes moved, 288 flop/byte, so bytes and operations nearly tie (0.50
// ms each for 16 frames of 640^2).  At 64 -> 3 the 134 bytes per pixel bound
// it (0.26 ms): the input must be read from device memory about once and the
// products must keep up with it.
//
// The streamed design.  A work unit is one image x a strip of 128 output
// columns x a band of R output rows.  The wrapper's plan
// (kernels/conv3x3.py: conv_plan) picks R and the grid: one persistent block
// per SM in all, walking units u = blockIdx.x, + gridDim.x, ...; for each it
// streams the band's R + 2 input rows, top to bottom, one 130-pixel halo row
// at a time:
// * One producer thread loads each row with TMA, a box of {64 channels, 130
//   pixels} from a 4-D tensor map over x with the 128-byte swizzle (one
//   pixel of 64 16-bit channels is one 128-byte swizzle row).  Coordinates
//   of -1 or past the edge are zero-filled by the hardware: that is the SAME
//   padding, with no branch and no padded copy.  Six 1024-byte-aligned row
//   slots, each with a full and an empty mbarrier, keep up to six rows in
//   flight.
// * Two consumer warpgroups, one m64 tile of 64 pixels each, read each
//   arriving row once into registers with ldmatrix (16-byte chunk j of box
//   pixel p sits at chunk j ^ (p % 8), so every dx shift is free of bank
//   conflicts) and release the slot (after a proxy fence: the next TMA write
//   into it must not overtake these reads).  Each A fragment then serves the
//   three output rows the row feeds: input row r adds tap dy into output row
//   r + 1 - dy, through three rolling fp32 accumulators (the row loop is
//   unrolled by three so that each accumulator has a fixed register name).
//   After input row r, output row r - 1 is complete and is stored.  Each
//   input value is read from device memory (R + 2) / R x 130 / 128 times,
//   1.06x at the benchmark's R = 50.
// * Products are wgmma.mma_async m64nNk16, A from registers, B from the
//   nine 64 x N weight taps, laid out once per block in wgmma's K-major
//   128-byte-swizzled layout and resident for the block's life (73.7 KB at
//   N = 64).  N is 8, 16, 32 or 64 (O <= 8, 16, 32, else 64; below about 48
//   channels the conv is bound by bytes, so the padded columns cost no
//   time); larger O tiles by 64 over the grid's y, each tile with its own
//   resident taps.  The two warpgroups issue their rows' products on their
//   own, so the tensor cores run one's products while the other stores its
//   finished row and loads its next one.  Three m64n64 accumulators and a
//   row's A fragments need more registers than an even split of 384
//   threads gives: setmaxnreg moves them from the producer warpgroup (40)
//   to the consumers (232); with fewer, ptxas serializes the wgmmas.
// * The epilogue adds the bias in fp32, rounds once, stages the row in
//   shared memory and stores it with 16-byte vectors where O % 8 = 0, or
//   with coalesced scalar stores (the out conv's 6-byte pixels, which no
//   tensor map takes).  The products of the band's first and last input
//   rows for rows outside the band go into accumulators that are never
//   stored: 2 rows' worth of products in R + 2.

// The wide design (C = 128 .. 512 and beyond, C % 64 = 0).  At C >= 128 a
// pixel costs 2 x 9C x O >= 295 kflop against at most 4 C bytes moved, so
// the tensor cores bound it; each input value is needed by nine taps and
// every output channel tile, and L2 has to feed them.
// * Work split (kernels/conv3x3.py: wide_plan).  Output tiles of M pixels
//   x N output channels: N = 128, or 256 where O >= 256, or O rounded up
//   to 8, 16, 32 or 64 below 64; M = 256 (each consumer warpgroup two m64
//   blocks) where N <= 128, else 128 (the accumulators of two m64n256
//   blocks would not fit).  Either way a stage moves 48 KB (or less) for
//   4.2 MFLOP: fewer bytes staged per flop than 128 x 128 tiles.  A tile's
//   pixels are a rectangle of `rows` x `cols` (cols = 16, 32, 64 or 128,
//   rows = M / cols): one TMA box, whatever W is; the plan picks the shape
//   that wastes the fewest pixels past the image's edges.  One
//   persistent block per SM walks tiles t = blockIdx.x, + gridDim.x, ...
//   with the channel tile fastest, then the strip, the band and the image:
//   the blocks at work at any moment read neighbouring rows, so a tile's
//   taps re-read rows that are still in L2.
// * K loop: 9 taps x C / 64 channel slices, tap-major (k = tap (C / 64) +
//   slice, the row order of the [9C, O] view of HWIO).  Step k stages
//   A, one TMA box {64 channels, cols, rows, 1} of x at (c0, x0 + dx - 1,
//   y0 + dy - 1, b): the hardware zero-fills coordinates outside the image,
//   which is the SAME padding; it lands as [M px][64 ch], 128-byte
//   swizzled, wgmma's K-major A layout.  B, the tap's [64 c][N o] slice of
//   the [9C, O] weights, as N / 64 boxes of 64 columns (one box, zero-filled
//   past O, for N < 64), lands O-contiguous and swizzled; wgmma reads it
//   with its B-transpose flag (MN-major), so the HWIO weights need no
//   relayout.  O % 8 != 0 gives no 16-byte row stride for a tensor map: the
//   wrapper then passes a copy of w padded with zeros to a multiple of 8.
// * A ring of four stages (up to 192 KB), each with a full and an empty
//   mbarrier.  One producer thread issues the loads; its warpgroup gives
//   its registers to the consumers (setmaxnreg).  Two consumer warpgroups,
//   one half of the tile each, issue a stage's wgmma.mma_async m64nNk16
//   (four k16 steps for each m64 block, A and B from shared memory) as one
//   group, keep it in flight, and release the previous stage once
//   wgmma.wait_group 1 says its group is done.
// * The epilogue adds the bias in fp32, rounds once, stages 64 pixels x 64
//   channels at a time in shared memory and stores 16-byte vectors
//   (coalesced scalars where O % 8 != 0).  Meanwhile the producer is
//   already loading the next tile's stages, but the tensor cores wait:
//   scripts/probe_wide_conv.py measures what that costs.

// The narrow design (16-bit, 1 <= C <= 7: VGG conv1_1's C = 3).  K = 9C <=
// 63 is small: at C = 3 -> 64 a pixel costs 2 x 27 x 64 = 3.5 kflop against
// 134 bytes moved (6 read, 128 written), 26 flop/byte, far below the card's
// ridge of about 295.  The output stream bounds it (95% of the bytes are
// stores: 0.262 ms for 16 frames of 640^2); the products take about a tenth
// of that even on mma.sync, so wgmma would buy nothing here.
// * Work split (kernels/conv3x3.py: narrow_plan).  Tiles of 8 rows x 32
//   columns of output pixels of one image, x N output channels (N = 64, or
//   8 where O <= 8; larger O tiles by 64 over the grid's y, as the streamed
//   design does).  Two persistent blocks per SM in all, split over the
//   channel tiles, walk tiles t = blockIdx.x, + gridDim.x, ... (strip
//   fastest, then band, image).
// * Input: the tile's 10 x 34 x C halo is read from device memory once per
//   tile (1.33x the input in all) with 2-byte loads, coalesced along each
//   halo row (one contiguous run of 34 C values in NHWC; its start is not
//   even 4-byte aligned at C = 3), zero outside the image: the SAME
//   padding.  The loads of tile t + 1 are issued into registers before tile
//   t's products and land in shared memory after them, in the other of two
//   halo buffers: one barrier per tile hands a halo to the warps.  A tensor
//   map over the input would need W C 2 % 16 = 0, which C = 3 rarely gives;
//   the input is 4.5% of the bytes.
// * K = 9C in one pass, padded to the next multiple of 16 (C = 3: 27 -> 32,
//   two k16 steps).  K index k is tap k / C, channel k % C (the row order of
//   HWIO's [9C, O] view), at offset (dy 34 + dx) C + c from the pixel in
//   the halo.  Each lane reads the offsets of its four k columns per step
//   from a table made once per block, and builds its m16n8k16 A fragments
//   straight from the halo with 2-byte loads.  A padded column's offset
//   points past the halo into a zeroed tail: A holds true zeros there, so
//   a non-finite input never meets a padded weight (inf x 0 = NaN).
// * The [K, N] weights are laid out once per block as m16n8k16 B fragments
//   in shared memory (one 8-byte load per lane, n8 tile and k16 step).
//   Eight warps, one tile row of 32 pixels each (two m16 tiles x N); each
//   tile's fp32 sums start from the bias.
// * The output stream.  Each warp rounds its row once and stages it in
//   shared memory with stmatrix as a TMA box {N, 32, 1, 1} of y (the
//   128-byte swizzle at N = 64, which also keeps those writes free of bank
//   conflicts; 4 KB, one contiguous run of y), and where O % 8 = 0 its lane
//   0 stores
//   the box with a TMA bulk tensor store (cp.async.bulk.tensor, shared ->
//   global): the hardware drops what falls past the image or past O.  No
//   barrier of the block waits for a store.  Each warp's staging is
//   double-buffered: its store of tile t drains while the block stages tile
//   t + 1's halo and runs its products, and the buffer is rewritten only
//   after cp.async.bulk.wait_group.read says that store has read it.  O %
//   8 != 0 (no 16-byte row stride for a tensor map): coalesced scalar
//   stores by the warp.
// * What holds it above the byte bound (scripts/probe_narrow_conv.py): the
//   output stream alone, through the same barriers and stores, runs near
//   the card's write rate, and so does the kernel without its halo reads;
//   the reads, 6% of the bytes, slow the stream by about a quarter.
//   Issuing them three tiles ahead (TMA bulk copies of each halo row's
//   aligned span) or steering L2 (evict-first stores, an evict-last
//   prefetch of x) did not recover it.

// The sliced design (16-bit, C >= 8 that is neither 64 nor a multiple of 64
// >= 128: C = 8, 32, 96, 100, 160, 200, ...).  It too replaces
// conv3x3_implicit_gemm.  At these widths K = 9C is short and the output
// is most of the bytes: [16,320,320,32] -> 64 moves 192 bytes a pixel, two
// thirds of them stores, for 36.9 kflop (0.094 ms of bytes against 0.061
// of products); the decoder's filter `up` conv [16,80,80,32] -> 512 moves
// 112 MB, 94% stores (0.0334 ms), for 30.2 GFLOP (0.0305 ms).  So it must
// read x about once, feed wgmma from shared memory and, above all, keep
// the output stream busy.
// * Work split (kernels/conv3x3.py: sliced_plan).  Tiles of 256 pixels
//   (rows x cols, cols = 16, 32, 64 or 128, narrowest of those that pad the
//   image least: taller tiles re-read fewer halo rows) x N output channels
//   (O rounded up to 8, 16, 32 or 64 below 64, else 128).  One persistent
//   block per SM walks tiles in wide_tile's order (channel tile fastest).
// * K in slices of KS = 16 channels where C <= 16, else 32 (a 16-channel
//   stage carries half the products for the same barrier round trip and
//   wgmma wait), x in TMA boxes {KS, cols, rows + 2, 1} with the 32- or
//   64-byte swizzle (the box's inner extent is the swizzle span).  A stage
//   is one slice at one dx: the box at (s KS, x0 + dx - 1, y0 - 1, b), and
//   the three taps (dy, dx), dy = 0, 1, 2, of the weights.  Its A for tap
//   dy starts dy x cols pixels into the box: cols is a multiple of 8, so
//   each tap's operand starts on a whole 8-row swizzle group and wgmma reads
//   it through a K-major descriptor (layout 64B or 32B, 8-row stride 8 KS 2
//   bytes), with no shifted copy.  Each input value is staged 3 (rows + 2)
//   / rows times per channel tile (3.4 at rows = 16), not nine.  The
//   weights are a 3-D tensor map [9][C][ld], boxes {64, KS, 1}: the
//   hardware zero-fills a slice's tail past C in B as in A (the box at
//   channel s KS reads past C only out of bounds), so both sides of a
//   padded K column are true zeros and a non-finite input never meets a
//   padded weight.  B lands O-contiguous with the 128-byte swizzle and
//   wgmma reads it MN-major (leading offset KS 128 bytes), as in the wide
//   design.  A ring of stages (as many as fit beside the output boxes and
//   the bias, at most 8: 6 and 3 at the two shapes above), one full and one
//   empty mbarrier each; one producer thread, two consumer warpgroups of
//   two m64 blocks each, a stage's 3 x KS / 16 x 2 wgmmas in flight as one
//   group while the previous stage is released.
// * C % 8 != 0 (C = 100: no 16-byte pixel stride, so no tensor map): the
//   wrapper hands the kernel copies of x and w zero-padded to C rounded up
//   to KS (the copy counts in the wrapper's time; a whole slice per pixel
//   keeps each box row on 32-byte sectors).  O % 8 != 0: a copy of w padded
//   to ld = O rounded up to 8, as in the wide design.
// * The output stream.  The fp32 sums start from the bias.  Each consumer
//   warpgroup rounds its finished 128 pixels once into staging boxes
//   {CW, min(cols, 64), 64 / min(cols, 64), 1} of y, one per m64 block and
//   CW = min(N, 64) channels (swizzled by CW x 2 bytes, so the writes are
//   free of bank conflicts), all behind one barrier and one proxy fence,
//   and one thread stores them with TMA bulk tensor stores; the hardware
//   drops what falls past the image or past O.  A box is rewritten a tile
//   later, after cp.async.bulk.wait_group.read says its store has read it,
//   so tile t's stores drain while tile t + 1's products run.  O % 8 != 0
//   (no tensor map over y): coalesced scalar stores from the same boxes.
//   The bias is staged in shared memory once per block: a tile's global
//   loads wait behind the ring's L2 traffic, and one box at a time, each
//   behind its own barriers, fence and bias loads, left the tensor cores
//   idle for a serial chain of waits (0.035 of the `up` conv's 0.077 ms).
// * No 64-channel slices: a stage's bytes per product do not depend on KS,
//   and a 64-channel stage at cols = 128, N = 128 (64 KB of A, 48 KB of
//   weights) leaves no room for a ring.
// * Measured (scripts/probe_sliced_conv.py, chip_smoke.py; NVIDIA H100
//   80GB HBM3 at 700 W): 0.139 ms at [16,320,320,32] -> 64 (68% of its
//   bound) and 0.068 at the `up` conv (49%), against F.conv2d's 0.475 and
//   0.224.  What remains is the staging from L2 and the epilogue under the
//   products.
// * Rejected: a generalized streamed design (32-channel halo rows, A
//   through ldmatrix, x read once).  Its family, the streamed kernel at C
//   = 64 on the same B, H, W and O, took 0.252 and 0.165 ms at the two
//   shapes (at O = 512 it re-streams x for each of 8 channel tiles).
// * C % 64 = 0, C >= 128 with O <= kSlicedMaxO: the wide design's tiles at
//   N <= 32 restage each input value nine times from L2 (one tap-shifted
//   box per tap and 64-channel slice) for few products; the sliced walk
//   stages it 3.4 times.  scripts/conv_ab.py's grid (C 128 / 256 / 512 at
//   320^2 / 160^2 / 80^2 x O 3 / 16 / 32 / 64, the two designs in turns)
//   sets the threshold (PERF.md section 6).

// The split-TF32 design (fp32, three passes, O > 32; both entry points).  The
// JAX package computes fp32 convs at HIGHEST precision; on this card fp32
// FMAs on the CUDA cores (67 TFLOP/s) bound [16,640,640,64] -> 64 at 7.2
// ms, half of cuDNN's 15 ms without TF32.  The tensor cores take TF32 (an
// fp32 exponent, 10 mantissa bits) at 495 TFLOP/s, so the products are
// made fp32-accurate by a split, as csrc/filter_chain.cu does: each
// operand v = hi + lo with hi, lo in TF32, and x w is taken as x_hi w_hi +
// x_hi w_lo + x_lo w_hi (three passes, fp32 accumulators; 2.9 ms of
// products at that shape).  What the split drops (x_lo w_lo, the lo
// values' truncation) is at most about 2^-19 of |x||w| a product, inside
// the checks' 9C 2^-22 sum |x||w|; measured, the tensor cores' own fp32
// accumulation dominates (4.5e-5 against a float64 conv at that shape,
// cuDNN's 6.9e-6).
// * The accumulation.  Each wgmma rounds its fp32 sum toward zero (the
//   sum of its k8 products and the accumulator, truncated), so a long chain
//   of them shrinks the result: at 9C / 8 chained x_hi w_hi steps and twice
//   as many corrections in one accumulator the outputs' mean signed error
//   was -6.2e-6 of their size, and a train step at 'high' moved 1.8e-4
//   from the exact one.  The corrections (x_hi w_lo, x_lo w_hi, 2^-11 of
//   the sum) go to an accumulator of their own, where truncation costs
//   2^-11 as much, and the two are added once in the epilogue: the main
//   chain truncates 9C / 8 times, not 27C / 8 (an emulation of truncating
//   wgmma sums puts the bias at a third; 32 more registers a thread at N =
//   64).
// * Tiles, walk and stages: the sliced design's (256-pixel tiles of rows x
//   cols, one persistent block per SM, channel tile fastest; a stage is one
//   K slice at one dx, whose halo'd box of x feeds the three taps dy at dy
//   x cols pixels in), with K slices of KS = 16 fp32 channels (8 where C <=
//   8): 64 bytes a pixel, the byte geometry of the f16 KS = 32 slice (the
//   64-byte swizzle; 32 at KS = 8).  N = 64, O tiling by 64 (at O <= 32
//   this walk lost to the rows design at every shape measured, at both
//   pass counts: PERF.md section 6, rows 3l and 3m).  Three stages of 60
//   KB at 16 x 16 tiles (x, its lo, the weights' 24 KB).
// * B must be K-major: PTX gives wgmma no transpose for .tf32 operands.
//   A small kernel (conv3x3_tf32_split_kernel, launched first on the same
//   stream) writes the wrapper's scratch tensor ws [2][9][O][Cp] once per
//   call: the HWIO weights transposed to [tap][o][c], split into hi and lo
//   planes (147 KB each at C = O = 64), zero past C.  A stage loads the
//   three taps' hi and lo boxes {KS, N, 1} of it with TMA, zero-filled past
//   O and past Cp.
// * A from shared memory.  The box of x as TMA lands it is x_hi: wgmma
//   reads an fp32 operand truncated to TF32.  Once a stage has landed,
//   both consumer warpgroups write x_lo = trunc_tf32(x - trunc_tf32(x)),
//   16 bytes a thread at a time, into a second box at the same offsets (so
//   under the same swizzle), fence, and meet at a barrier; then each issues
//   the stage's x_hi B_hi, x_hi B_lo and x_lo B_hi as shared-memory
//   wgmma.mma_async m64nNk8 .tf32, one group in flight while the next
//   stage's lo is written.  Rejected: A from registers (each warp loads its
//   fragments of each tap with ldmatrix and splits them in registers,
//   three times a stage per value; no second box, no barrier): 5.11 ms
//   against this design's 4.70 in one call, and 5.27 against 4.75 in
//   another (scripts/probe_tf32_conv.py `a_from_registers`; NVIDIA H100
//   80GB HBM3 at 700 W).  Splitting once per value outweighs reading A from
//   shared memory twice more.
// * The split, in integer operations (cvt.rna.tf32.f32 runs on the
//   conversion unit at 16 a clock per SM: it cost the register-A route
//   0.45 ms more at that shape).  x:
//   hi is x truncated (the tensor cores' reading), lo = x - hi (exact, of
//   x's sign) truncated, 0 where x is a TF32 value, +-inf or a NaN that
//   truncation keeps; +-FLT_MAX splits into finite halves.  w (in the
//   split kernel): hi is w truncated, lo = rna TF32 of w - hi, never of hi's
//   opposite sign, and where that lo is 0 but w is not it becomes hi 2^-30
//   (the same sign; 2^-30 of |x||w| a product).  So an infinite x meets a
//   non-zero weight as x_hi w_hi + x_hi w_lo = +-inf, as in an fp32 conv,
//   never as inf - inf or inf 0; NaN stays NaN.  Weights are taken to be
//   finite (an infinite weight would meet x_lo = 0 as inf 0).  The padded
//   K columns are true zeros on both sides.
// * x needs a 16-byte pixel stride for its tensor map: where C % 4 != 0 the
//   wrapper hands the kernel a copy zero-padded to Cp = C rounded up to 4
//   (the copy counts in the wrapper's time).
// * The output: each thread stores its accumulator pairs as 8-byte vectors
//   straight from registers (four lanes write one row's 32 contiguous
//   bytes: whole sectors), where they fall inside the image and O.  An
//   fp32 tile is 64 KB at N = 64, too much to stage beside the ring.
// * What bounds it (scripts/probe_tf32_conv.py at [16,640,640,64] -> 64):
//   one pass alone 2.73 ms, no wgmma at all 2.64, the lo pass 0.67 of the
//   4.70, the stores 0.19.  Each m64nNk8 reads 2 KB of A and N 32 bytes of
//   B from shared memory for 32 clocks of products at N = 64: with the lo
//   pass and the TMA writes, a stage moves about 370 KB through shared
//   memory for 2304 clocks of products, more than its 128 bytes a clock.

// The one-pass design (fp32, passes = 1, O > 32; rr_conv3x3 with R > 0).
// One TF32 pass, x and w rounded to nearest, on the split-TF32 kernel's
// walk with the operands swapped: the weights are
// wgmma's A (M = 64 output channels a block, from the split kernel's one
// plane ws[tap][o][Cp], rounded once a call and already K-major, so A
// needs no work in shared memory) and the box of x is B (N = 128 or 256
// pixels, K-major as NHWC lies; tap dy moves B's start by dy rows of cols
// pixels, whole 8-row swizzle groups, and dx keeps a box of its own, as a
// one-pixel shift would break the swizzle groups).
// * What bounded the old orientation at [16,640,640,64] -> 64 (3.50 ms
//   against a 1.00 ms bound): shared memory.  Each m64n64k8 read 2 KB of
//   A (x) and 2 KB of B for 32 clocks of products, 128 bytes a clock, all
//   an SM's shared memory gives; a stage (one 16-channel slice at one dx,
//   24 such wgmmas: 768 clocks) moved 96 KB of operands, 30 KB of TMA
//   writes and 37 KB of rounding (the box read and written), 1296 clocks
//   at 128 bytes a clock; and both warpgroups rounded the box together and
//   met at one barrier before either issued the stage's products.
// * The reckoning (kernels/conv3x3.py: tf32x1_stage_reckoning; a stage,
//   both warpgroups, KS = 16, 16-column tiles): m64n256k8 reads 2 + 8 KB
//   for 128 clocks (80 bytes a clock), m64n128k8 2 + 4 KB for 64 (96).
//     MB x NPX   tile px x ch   clocks   operands  TMA    rounding  ratio
//     1 x 256    512 x 64       1536     120 KB    46 KB  72 KB     1.24
//     2 x 128    256 x 128      1536     144 KB    42 KB  40 KB     1.18
//     1 x 128    256 x 64        768      72 KB    30 KB  40 KB     1.48
//   (ratio: the stage's shared-memory bytes at 128 a clock over its
//   clocks of products; the old orientation's was 1.69).  The wrapper's
//   plan (tf32x1_plan) takes the shape whose reckoned clocks (stages x the
//   larger of products and bytes, x the rounds of tiles over the SMs) are
//   least: 2 x 128 where O > 64 (one box, loaded and rounded once, feeds
//   128 output channels), else 1 x 256; 1 x 128 where the larger tiles
//   would leave SMs idle (32^2 and 64^2 images of a train step).
// * Rounding: each consumer warpgroup rounds, in place, the box pixels its
//   own taps read, [NPX wg, NPX wg + NPX + 2 cols) (tf32_round_x: inf, NaN
//   and values near FLT_MAX as in the split-TF32 kernel), fences and waits
//   at its own 128-thread barrier: the two drift apart, and one's rounding
//   overlaps the other's products.  Rounding is idempotent: the 2 cols
//   pixels both read may be written twice, with the same bits.
// * Tiles, walk and stages as the split-TF32 kernel's (persistent blocks,
//   channel tile fastest, a stage one K slice at one dx), tiles of 2 NPX
//   pixels (rows x cols) x 64 MB channels; each consumer warpgroup takes
//   NPX pixels, its rows / 2 rows, for every channel of the tile.  The
//   weights' boxes {KS, 64, 1} of ws are zero-filled past O and Cp, and the
//   padded K columns of x are true zeros, as in the split-TF32 kernel.
// * The epilogue: the sums lie [channel][pixel] and y wants channels
//   contiguous.  Each warpgroup stages 32 / MB pixels x 64 MB channels at a
//   time (8 KB: 2 MB boxes of 32 channels with the 128-byte swizzle, so a
//   warp's 32 accumulator writes fall in 32 banks) into one of two
//   buffers, and one thread stores the boxes with TMA; the stores drain
//   while the next chunk is staged and the next tile's products run
//   (scalar stores where O % 4 != 0).  The producer meanwhile loads the
//   next tile's stages.
// * Measured (scripts/conv_ab.py --tf32x1, scripts/probe_tf32_conv.py;
//   NVIDIA H100 80GB HBM3 at 700 W): 2.57 ms at [16,640,640,64] -> 64
//   against the old orientation's 3.46 and cuDNN TF32's 3.54 (39% of its
//   bound).  Without the rounding 1.61, without the wgmmas 2.30; dropping
//   the proxy fence or keeping two groups of wgmmas in flight changes
//   nothing, and both warpgroups rounding behind one barrier reads 2.71:
//   the rounding costs shared-memory traffic, not latency.  Each value is
//   still loaded and rounded once per dx box, three times a slice.
//   Rejected in the old orientation, both slower than rounding the box:
//   the producer warpgroup's idle warps rounding ahead of a `ready`
//   barrier (5.32 ms), and x as register A, its ldmatrix fragments rounded
//   in registers (5.13-5.14 ms).  As B, x has no register form.

// Split K (both fp32 kernels, conv3x3_tf32x3_kernel and
// conv3x3_tf32x1_kernel).  Where a call has fewer tiles than the card has
// SMs (a train step's 32^2 images: [4,32,32,512] -> 32 makes 16 tiles of
// 256 pixels, and each walked all 96 stages while 116 SMs stayed idle),
// each tile's K is split over `splits` blocks (kernels/conv3x3.py:
// tf32x3_plan, tf32x1_plan pick it; 1 wherever the tiles fill the SMs, so
// every plan at the 640^2 batch shapes is as before).
// * The persistent blocks walk units (tile, split), split fastest, so a
//   tile's units run side by side; split s takes the contiguous run of K
//   slices [s slices / splits, (s + 1) slices / splits), 3 stages a slice
//   as before.  Split 0's sums start from the bias, the others' from 0.
// * Each consumer warpgroup writes its fp32 partial (the split-TF32
//   kernel's acc + cor, as the epilogue adds them) to the workspace after
//   the weights' scratch, 16-byte vectors in its threads' register order
//   (so the writes and the reads below are coalesced whatever the tile's
//   layout), fences it, and
//   one thread counts the warpgroup in on a counter of its half tile (the
//   weights' split kernel zeroes the counters first, on the same stream).
//   The warpgroup that counts in last reads every split's partial of its
//   half tile from L2 and sums them in split order, then runs the
//   epilogue as an unsplit tile does: whichever block finishes last, the
//   sums are the same bits.  No atomics on values; an inf in one partial
//   stays inf, inf + -inf across splits is NaN, as within one accumulator.
//   A last-to-finish sum, not a second kernel: at 0.02 ms a launch counts.
// * A split takes at least 3 slices where the plan chooses (9 stages: the
//   ring of up to 8 still fills).  As for the weight gradient, a
//   reduction inside thread block clusters was no faster than a workspace
//   at equal splits (csrc/conv3x3_wgrad.cu).
// * The kernels take the split as a template flag (kSplit): with the
//   split count a runtime value in one kernel body, tiles walked whole
//   ran up to a quarter slower at some one-pass shapes
//   (scripts/conv_ab.py --tf32x1; PERF.md section 6), so the unsplit
//   instances keep the unsplit walk's code, and only KS = 16 has split
//   instances (C <= 8 is one slice).

// Offsets are 64-bit: a batch of 16 frames of 640^2 x 64 holds 4.2e8
// values.
#include "common.cuh"
#include "hopper.cuh"

#include <algorithm>
#include <type_traits>
#include <utility>

namespace {

// The streamed design.
constexpr int kC = 64;                     // input channels it takes
constexpr int kTW = 128;                   // output pixels per strip
constexpr int kBoxPix = kTW + 2;           // pixels per TMA row box
constexpr int kBoxBytes = kBoxPix * kC * 2;                   // 16640
constexpr int kSlotBytes = (kBoxBytes + 1023) / 1024 * 1024;  // 17408
constexpr int kSlots = 6;                  // input rows in flight
constexpr int kConsumerThreads = 256;      // two warpgroups
// + a producer warpgroup: one thread issues the loads, but setmaxnreg hands
// registers over by whole warpgroups.  The wide design has the same roles.
constexpr int kSpecThreads = kConsumerThreads + 128;

// The wide design.
constexpr int kBChunk = 64 * 64 * 2;       // 8192: 64 k x 64 o of B
constexpr int kRingBytes = 196608;         // all stages of the ring

template <int BN>
struct Wide {
  // Output pixels per tile: 256 (two m64 blocks per consumer warpgroup)
  // where the accumulators fit, 128 at N = 256.
  static constexpr int kM = BN <= 128 ? 256 : 128;
  static constexpr int kMB = kM / 128;                    // m64 blocks a WG
  static constexpr int kASlot = kM * 64 * 2;              // one A box
  static constexpr int kChunks = BN >= 64 ? BN / 64 : 1;  // B boxes a stage
  static constexpr int kStageBytes = kASlot + kChunks * kBChunk;
  static constexpr int kStages = kRingBytes / kStageBytes;  // 4
  static constexpr int kCW = BN < 64 ? BN : 64;  // epilogue chunk width
  static constexpr int kLDS = kCW + 8;           // its padded row
  static constexpr size_t kSmem = 1024                    // base alignment
                                  + (size_t)kStages * kStageBytes
                                  + 2 * 64 * kLDS * 2     // output staging
                                  + 2 * kStages * 8;      // mbarriers
};

// The sliced design: tiles of 256 pixels x BN channels, K slices of KS.
template <int BN, int KS>
struct Sliced {
  static constexpr int kM = 256;                          // pixels a tile
  static constexpr int kChunks = BN >= 64 ? BN / 64 : 1;  // B boxes a tap
  static constexpr int kBBox = KS * 128;                  // {64 o, KS c}
  static constexpr int kBTaps = 3 * kChunks * kBBox;      // a stage's B
  static constexpr int kCW = BN < 64 ? BN : 64;           // staged channels
  static constexpr int kOutBox = 64 * kCW * 2;            // 64 px x kCW
  static constexpr int kOutBoxes = 2 * (BN / kCW);        // a warpgroup's tile
  static constexpr int kFixed = 1024                      // base alignment
                                + 2 * kOutBoxes * kOutBox;
};
constexpr int kSlicedMaxStages = 8;
// 16-bit C % 64 = 0, C >= 128 with O <= kSlicedMaxO take the sliced design.
constexpr int kSlicedMaxO = 64;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

// ---------------------------------------------------------------------------
// PTX helpers (the cp.async ones are in common.cuh)
// ---------------------------------------------------------------------------

// A fragment of m16n8k16 (and, per warp, of wgmma's register A): a 16 x 16
// row-major tile; lane l names row l % 16, columns 8 (l / 16) .. +7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]);

template <>
__device__ __forceinline__ void mma16816<__half>(float (&d)[4],
                                                 const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A barrier of the two consumer warpgroups (id 3).
__device__ __forceinline__ void bar_sync_consumers() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// wgmma.mma_async m64nNk16, fp32 accumulators d (N / 2 per thread), A from
// registers (4 x 2 values), B through the descriptor desc + Off (Off in
// 16-byte units, added inside the asm so that the compiler does not keep
// every tap's descriptor live in registers), K-major; scale_d = 0 starts d
// afresh (d = A B, the old d unread).
#define RR_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RR_D8(i) RR_D4(i), RR_D4(i + 4)
#define RR_D16(i) RR_D8(i), RR_D8(i + 8)
#define RR_D32(i) RR_D16(i), RR_D16(i + 16)
#define RR_WGMMA_IN \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(Off), "r"(scale_d)

#define RR_WGMMA_N8(TY)                                               \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %10, 0;\n"     \
      "add.s64 dd, %8, %9;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n8k16.f32." TY "." TY " "      \
      "{%0, %1, %2, %3}, "                                            \
      "{%4, %5, %6, %7}, dd, p, 1, 1, 0;\n}\n"                        \
      : RR_D4(0)                                                      \
      : RR_WGMMA_IN)

#define RR_WGMMA_N16(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %14, 0;\n"     \
      "add.s64 dd, %12, %13;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "                            \
      "{%8, %9, %10, %11}, dd, p, 1, 1, 0;\n}\n"                      \
      : RR_D8(0)                                                      \
      : RR_WGMMA_IN)

#define RR_WGMMA_N32(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %22, 0;\n"     \
      "add.s64 dd, %20, %21;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15}, "                       \
      "{%16, %17, %18, %19}, dd, p, 1, 1, 0;\n}\n"                    \
      : RR_D16(0)                                                     \
      : RR_WGMMA_IN)

#define RR_WGMMA_N64(TY)                                              \
  asm volatile(                                                       \
      "{\n.reg .pred p;\n.reg .b64 dd;\nsetp.ne.b32 p, %38, 0;\n"     \
      "add.s64 dd, %36, %37;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "     \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                             \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                        \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                      \
      "%24, %25, %26, %27, %28, %29, %30, %31}, "                     \
      "{%32, %33, %34, %35}, dd, p, 1, 1, 0;\n}\n"                    \
      : RR_D32(0)                                                     \
      : RR_WGMMA_IN)

template <typename T, int N, int Off>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], const uint32_t (&a)[4],
                                      uint64_t desc, int scale_d) {
  constexpr bool f16 = std::is_same<T, __half>::value;
  if constexpr (N == 8) {
    if constexpr (f16) RR_WGMMA_N8("f16"); else RR_WGMMA_N8("bf16");
  } else if constexpr (N == 16) {
    if constexpr (f16) RR_WGMMA_N16("f16"); else RR_WGMMA_N16("bf16");
  } else if constexpr (N == 32) {
    if constexpr (f16) RR_WGMMA_N32("f16"); else RR_WGMMA_N32("bf16");
  } else {
    static_assert(N == 64, "wgmma width");
    if constexpr (f16) RR_WGMMA_N64("f16"); else RR_WGMMA_N64("bf16");
  }
}

// One box of a 2-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of an N-contiguous (MN-major) B operand
// with the 128-byte swizzle, as TMA lands 64-column boxes of a [k][o]
// row-major matrix: each k row of a box is one 128-byte swizzle row, eight
// rows make a 1024-byte group.  Leading offset: 8192 bytes from one
// 64-column box to the next along N; stride offset: 1024 bytes from one
// group of eight k rows to the next.  A k16 step adds 2048 bytes.  The
// sliced design's boxes hold KS k rows: leading offset `lbo` = KS 128.
__device__ __forceinline__ uint64_t wgmma_desc_mn(uint32_t addr,
                                                  uint32_t lbo = kBChunk) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}

// wgmma.mma_async m64nNk16 with A and B from shared memory: A K-major
// (descriptor da), B MN-major (db, the transpose flag set); fp32
// accumulators d; scale_d = 0 starts d afresh.  For T = float,
// m64nNk8 .tf32 with both operands K-major.
#define RR_ACC4 "%0, %1, %2, %3"
#define RR_ACC8 RR_ACC4 ", %4, %5, %6, %7"
#define RR_ACC16 RR_ACC8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define RR_ACC32                                                       \
  RR_ACC16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
           "%27, %28, %29, %30, %31"
#define RR_ACC64                                                       \
  RR_ACC32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
           "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
           "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define RR_ACC128                                                      \
  RR_ACC64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, " \
           "%75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "   \
           "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "   \
           "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, " \
           "%107, %108, %109, %110, %111, %112, %113, %114, %115, "    \
           "%116, %117, %118, %119, %120, %121, %122, %123, %124, "    \
           "%125, %126, %127"
#define RR_D64(i) RR_D32(i), RR_D32(i + 32)
#define RR_D128(i) RR_D64(i), RR_D64(i + 64)

// N, K, TY: the shape's width and depth and the type as PTX strings; TR:
// the transpose flags (", 0, 1": A K-major, B MN-major; "" for .tf32,
// which takes none: both K-major); ACC, D: the accumulators' operand list
// and constraints; IA, IB, IS: the operand numbers of da, db and scale_d
// (N / 2, N / 2 + 1, N / 2 + 2).
#define RR_WGMMA_SS(N, K, TY, TR, ACC, D, IA, IB, IS)                   \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"         \
               "wgmma.mma_async.sync.aligned.m64n" N K ".f32." TY "."   \
               TY " {" ACC "}, %" IA ", %" IB ", p, 1, 1" TR ";\n}\n"   \
               : D                                                      \
               : "l"(da), "l"(db), "r"(scale_d))

#define RR_WGMMA_SS_ALL(K, TY, TR)                                            \
  if constexpr (N == 8)                                                       \
    RR_WGMMA_SS("8", K, TY, TR, RR_ACC4, RR_D4(0), "4", "5", "6");            \
  else if constexpr (N == 16)                                                 \
    RR_WGMMA_SS("16", K, TY, TR, RR_ACC8, RR_D8(0), "8", "9", "10");          \
  else if constexpr (N == 32)                                                 \
    RR_WGMMA_SS("32", K, TY, TR, RR_ACC16, RR_D16(0), "16", "17", "18");      \
  else if constexpr (N == 64)                                                 \
    RR_WGMMA_SS("64", K, TY, TR, RR_ACC32, RR_D32(0), "32", "33", "34");      \
  else if constexpr (N == 128)                                                \
    RR_WGMMA_SS("128", K, TY, TR, RR_ACC64, RR_D64(0), "64", "65", "66");     \
  else                                                                        \
    RR_WGMMA_SS("256", K, TY, TR, RR_ACC128, RR_D128(0), "128", "129", "130")

template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 64 || N == 128 ||
                    N == 256,
                "wgmma width");
  if constexpr (std::is_same<T, float>::value) {
    RR_WGMMA_SS_ALL("k8", "tf32", "");
  } else if constexpr (std::is_same<T, __half>::value) {
    RR_WGMMA_SS_ALL("k16", "f16", ", 0, 1");
  } else {
    RR_WGMMA_SS_ALL("k16", "bf16", ", 0, 1");
  }
}

// Two fp32 values rounded to the storage dtype, packed low first.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// 16-bit, C = 64: rows streamed down column strips (the design above)
// ---------------------------------------------------------------------------

template <int BN>
constexpr size_t stream_smem_bytes() {
  return 1024                        // slack to align the base to 1024 bytes
         + 9 * BN * 128              // the nine weight taps
         + kSlots * kSlotBytes       // input row slots
         + 2 * 64 * (BN + 8) * 2     // output staging, one tile per warpgroup
         + BN * 4                    // the bias, fp32
         + 2 * kSlots * 8;           // full and empty mbarriers
}

// Work unit u: image b, output rows y0 .. y0 + rows - 1, columns x0 .. +127.
// The order (strip fastest, then band, then image) is the wrapper's plan's
// (kernels/conv3x3.py: ConvPlan.unit).
struct Unit {
  int b, y0, x0, rows;
};

__device__ __forceinline__ Unit unit_of(long long u, int strips, int bands,
                                        int R, int H) {
  Unit t;
  t.x0 = (int)(u % strips) * kTW;
  const long long q = u / strips;
  t.y0 = (int)(q % bands) * R;
  t.b = (int)(q / bands);
  t.rows = min(R, H - t.y0);
  return t;
}

// What a consumer thread keeps across the rows of its units.
struct Consumer {
  uint32_t slots, full, empty;  // shared addresses of slot 0 and barriers
  uint64_t desc0;               // wgmma descriptor of weight tap 0
  int p0;                       // this lane's ldmatrix pixel at dx = 0
  int hi;                       // this lane's 8-channel half of a k16 step
  int lane, warp, wg, tid;      // tid within the warpgroup
  int s;                        // the next slot
  uint32_t ph;                  // its phase parity
};

// One finished output row (this warpgroup's 64 pixels from pixel index
// `pix`, `npx` of them inside the image): + bias, rounded once,
// staged in shared memory, stored with 16-byte vectors (O % 8 = 0) or
// coalesced scalars.
template <typename T, int BN>
__device__ __forceinline__ void stream_store(const float (&acc)[BN / 2],
                                             const Consumer& c, T* st,
                                             const float* bias_s,
                                             T* __restrict__ y, long long pix,
                                             int npx, int O, int n0) {
  constexpr int LDO = BN + 8;
  bar_sync_wg(1 + c.wg);  // the previous row's copy-out has read `st`
  const int r = c.warp * 16 + (c.lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + (c.lane & 3) * 2;
    const float b0 = bias_s[col], b1 = bias_s[col + 1];
    *reinterpret_cast<uint32_t*>(st + r * LDO + col) =
        pack2<T>(acc[4 * j] + b0, acc[4 * j + 1] + b1);
    *reinterpret_cast<uint32_t*>(st + (r + 8) * LDO + col) =
        pack2<T>(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
  }
  bar_sync_wg(1 + c.wg);
  const int oc = min(BN, O - n0);
  if (O % 8 == 0) {
    constexpr int VPR = BN / 8;
    for (int i = c.tid; i < 64 * VPR; i += 128) {
      const int px = i / VPR, v = i % VPR;
      if (px < npx && v * 8 < oc)
        *reinterpret_cast<uint4*>(y + (pix + px) * O + n0 + v * 8) =
            *reinterpret_cast<const uint4*>(st + px * LDO + v * 8);
    }
  } else {
    for (int i = c.tid; i < npx * oc; i += 128) {
      const int px = i / oc, ch = i % oc;
      y[(pix + px) * O + n0 + ch] = st[px * LDO + ch];
    }
  }
}

// One k16 step of a row's products: A fragment (dx, k) times the taps
// (dy, dx), channels 16 k .. 16 k + 15, for dy = 0, 1, 2 into acc[F],
// acc[M], acc[D]; tap (0, 0) of k = 0 starts acc[F] afresh.
template <typename T, int BN, int F, int M, int D, int I>
__device__ __forceinline__ void issue_k16(float (&acc)[3][BN / 2],
                                          const uint32_t (&a)[3][4][4],
                                          uint64_t desc0) {
  constexpr int dx = I / 4, k = I % 4;
  constexpr int off = dx * BN * 8 + 2 * k;  // 16-byte units into the taps
  wgmma<T, BN, off>(acc[F], a[dx][k], desc0, I > 0);
  wgmma<T, BN, 3 * BN * 8 + off>(acc[M], a[dx][k], desc0, 1);
  wgmma<T, BN, 6 * BN * 8 + off>(acc[D], a[dx][k], desc0, 1);
}

template <typename T, int BN, int F, int M, int D, int... I>
__device__ __forceinline__ void issue_row(float (&acc)[3][BN / 2],
                                          const uint32_t (&a)[3][4][4],
                                          uint64_t desc0,
                                          std::integer_sequence<int, I...>) {
  (issue_k16<T, BN, F, M, D, I>(acc, a, desc0), ...);
}

// Input row t of a unit (image row y0 - 1 + t), as the P-th of three
// consecutive rows (P = t % 3): its taps dy = 0, 1, 2 go into output rows
// t, t - 1, t - 2 of the unit, held in acc[P], acc[(P + 2) % 3] and
// acc[(P + 1) % 3]; tap dy = 0 starts its accumulator afresh.  After it,
// output row t - 2 is complete and is stored (t >= 2).
template <typename T, int BN, int P>
__device__ __forceinline__ void stream_row(float (&acc)[3][BN / 2],
                                           Consumer& c, int t, T* st,
                                           const float* bias_s,
                                           T* __restrict__ y, long long pix,
                                           int W, int npx, int O, int n0) {
  constexpr int kFresh = P, kMid = (P + 2) % 3, kDone = (P + 1) % 3;
  mbar_wait(c.full + 8 * c.s, c.ph);
  const uint32_t slot = c.slots + c.s * kSlotBytes;
  const uint32_t empty = c.empty + 8 * c.s;
  uint32_t a[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int p = c.p0 + dx;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      ldsm_x4(a[dx][k], slot + p * 128 + (((2 * k + c.hi) ^ (p & 7)) << 4));
  }
  // The row is in registers: release the slot.  The fence orders these
  // generic-proxy reads before the next TMA (async-proxy) write into it;
  // without it the last pixels of a row could be overwritten before they
  // were read.
  fence_async_shared();
  __syncwarp();
  if (c.lane == 0) mbar_arrive(empty);
  if (++c.s == kSlots) {
    c.s = 0;
    c.ph ^= 1;
  }
  fence_regs(acc);
  wgmma_fence();
  issue_row<T, BN, kFresh, kMid, kDone>(acc, a, c.desc0,
                                        std::make_integer_sequence<int, 12>{});
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
  if (t >= 2)
    stream_store<T, BN>(acc[kDone], c, st, bias_s, y,
                        pix + (long long)(t - 2) * W, npx, O, n0);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kSpecThreads, 1) conv3x3_stream_kernel(
    const __grid_constant__ CUtensorMap xmap, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ y, int B, int H, int W, int O,
    int R) {
  constexpr int LDO = BN + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ws =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* slots = ws + 9 * BN * 128;
  T* stage = reinterpret_cast<T*>(slots + kSlots * kSlotBytes);
  float* bias_s = reinterpret_cast<float*>(stage + 2 * 64 * LDO);
  const uint32_t full = smem_addr(bias_s + BN), empty = full + 8 * kSlots;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * BN;
  const T zero = rr_from_float<T>(0.f);

  // The nine taps of output channels n0 .. n0 + BN - 1, once per block:
  // tap t, channel n, input channel c at t BN 128 + n 128 + 16 ((c / 8) ^
  // (n % 8)) + 2 (c % 8) bytes, wgmma's K-major 128B-swizzled layout (the
  // HWIO layout's O-contiguous rows transposed on the way in).
  for (int i = tid; i < 9 * kC * BN; i += kSpecThreads) {
    const int n = i % BN, ch = (i / BN) % kC, tap = i / (BN * kC);
    const int o = n0 + n;
    T* dst = reinterpret_cast<T*>(ws + tap * BN * 128 + n * 128 +
                                  (((ch >> 3) ^ (n & 7)) << 4)) +
             (ch & 7);
    *dst = o < O ? w[((long long)tap * kC + ch) * O + o] : zero;
  }
  for (int n = tid; n < BN; n += kSpecThreads)
    bias_s[n] = bias != nullptr && n0 + n < O ? rr_to_float(bias[n0 + n]) : 0.f;
  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  fence_async_shared();
  __syncthreads();

  const int strips = (W + kTW - 1) / kTW;
  const int bands = (H + R - 1) / R;
  const long long units = (long long)B * bands * strips;

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every unit's rows y0 - 1 ..
    // y0 + rows, pixels x0 - 1 .. x0 + 128, into the ring of slots.
    regs_release();
    if (tid == kConsumerThreads) {
      int s = 0;
      uint32_t ph = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit un = unit_of(u, strips, bands, R, H);
        for (int t = 0; t < un.rows + 2; ++t) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, kBoxBytes);
          tma_load_4d(smem_addr(slots) + s * kSlotBytes, &xmap, full + 8 * s,
                      0, un.x0 - 1, un.y0 - 1 + t, un.b);
          if (++s == kSlots) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes pixels x0 + 64 wg .. + 63.
  regs_claim();
  Consumer c;
  c.slots = smem_addr(slots);
  c.full = full;
  c.empty = empty;
  c.desc0 = wgmma_desc(smem_addr(ws));
  c.lane = tid & 31;
  c.warp = (tid >> 5) & 3;
  c.wg = tid >> 7;
  c.tid = tid & 127;
  c.p0 = c.wg * 64 + c.warp * 16 + (c.lane & 15);
  c.hi = c.lane >> 4;
  c.s = 0;
  c.ph = 0;
  T* st = stage + c.wg * 64 * LDO;
  float acc[3][BN / 2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.f;

  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit un = unit_of(u, strips, bands, R, H);
    const int xw = un.x0 + c.wg * 64;
    const long long pix = ((long long)un.b * H + un.y0) * W + xw;
    const int npx = min(64, W - xw);
    const int nt = un.rows + 2;
    for (int t = 0; t < nt; t += 3) {
      stream_row<T, BN, 0>(acc, c, t, st, bias_s, y, pix, W, npx, O, n0);
      if (t + 1 < nt)
        stream_row<T, BN, 1>(acc, c, t + 1, st, bias_s, y, pix, W, npx, O, n0);
      if (t + 2 < nt)
        stream_row<T, BN, 2>(acc, c, t + 2, st, bias_s, y, pix, W, npx, O, n0);
    }
  }
}

// ---------------------------------------------------------------------------
// 16-bit, C % 64 = 0, C >= 128 (rr_conv3x3): the wide design (above)
// ---------------------------------------------------------------------------

// Tile t: image b, output rows y0 .. y0 + rows - 1, columns x0 .. x0 + cols
// - 1, output channels n0 .. n0 + BN - 1.  The order (channel tile
// fastest, then strip, band, image) is the wrapper's plan's
// (kernels/conv3x3.py: WidePlan.tile).
struct WideTile {
  int b, y0, x0, n0;
};

__device__ __forceinline__ WideTile wide_tile(long long t, int n_tiles,
                                              int strips, int bands, int rows,
                                              int cols, int bn) {
  WideTile u;
  u.n0 = (int)(t % n_tiles) * bn;
  long long q = t / n_tiles;
  u.x0 = (int)(q % strips) * cols;
  q /= strips;
  u.y0 = (int)(q % bands) * rows;
  u.b = (int)(q / bands);
  return u;
}

// One stage's products for a warpgroup: four k16 steps (A + 32 i bytes,
// B + 2048 i bytes: 2 i and 128 i in 16-byte units) into each of its kMB
// m64 blocks (A + 8192 bytes a block); `fresh` starts the sums afresh.
template <typename T, int BN>
__device__ __forceinline__ void wide_stage(float (&acc)[Wide<BN>::kMB][BN / 2],
                                           uint64_t da, uint64_t db,
                                           bool fresh) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < Wide<BN>::kMB; ++m)
      wgmma_ss<T, BN>(acc[m], da + 512 * m + 2 * i, db + 128 * i,
                      !(fresh && i == 0));
}

// A finished m64 block of a warpgroup, tile pixels p0 .. p0 + 63 (pixel p
// sits at row p / cols, column p % cols of the tile): + bias, rounded
// once, staged kCW channels at a time in shared memory, stored with 16-byte
// vectors (O % 8 = 0) or coalesced scalars.  `bar`: the warpgroup's named
// barrier.
template <typename T, int BN>
__device__ __forceinline__ void wide_store(const float (&acc)[BN / 2], T* st,
                                           const T* __restrict__ bias,
                                           T* __restrict__ y,
                                           const WideTile& u, int H, int W,
                                           int O, int lc, int p0, int bar,
                                           int wtid) {
  constexpr int CW = Wide<BN>::kCW, LDS = Wide<BN>::kLDS, VPR = CW / 8;
  const int lane = wtid & 31;
  const int r = (wtid >> 5) * 16 + (lane >> 2);
  const int cmask = (1 << lc) - 1;
#pragma unroll
  for (int c = 0; c < BN / CW; ++c) {
    const int nc = u.n0 + c * CW;  // the chunk's first output channel
    bar_sync_wg(bar);  // the previous chunk's copy-out has read `st`
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      const int o = nc + col;
      const float b0 = bias != nullptr && o < O ? rr_to_float(bias[o]) : 0.f;
      const float b1 =
          bias != nullptr && o + 1 < O ? rr_to_float(bias[o + 1]) : 0.f;
      const int a = 4 * (c * CW / 8 + j);
      *reinterpret_cast<uint32_t*>(st + r * LDS + col) =
          pack2<T>(acc[a] + b0, acc[a + 1] + b1);
      *reinterpret_cast<uint32_t*>(st + (r + 8) * LDS + col) =
          pack2<T>(acc[a + 2] + b0, acc[a + 3] + b1);
    }
    bar_sync_wg(bar);
    const int oc = O - nc;  // channels of this chunk inside O (may be <= 0)
    if (O % 8 == 0) {
      for (int i = wtid; i < 64 * VPR; i += 128) {
        const int px = i / VPR, v = i % VPR;
        const int p = p0 + px;
        const int yy = u.y0 + (p >> lc), xx = u.x0 + (p & cmask);
        if (yy < H && xx < W && v * 8 < oc)
          *reinterpret_cast<uint4*>(
              y + (((long long)u.b * H + yy) * W + xx) * O + nc + v * 8) =
              *reinterpret_cast<const uint4*>(st + px * LDS + v * 8);
      }
    } else {
      for (int i = wtid; i < 64 * CW; i += 128) {
        const int px = i / CW, ch = i % CW;
        const int p = p0 + px;
        const int yy = u.y0 + (p >> lc), xx = u.x0 + (p & cmask);
        if (yy < H && xx < W && ch < oc)
          y[(((long long)u.b * H + yy) * W + xx) * O + nc + ch] =
              st[px * LDS + ch];
      }
    }
  }
}

// xmap: x as [B][H][W][C], boxes {64, cols, kM / cols, 1}; wmap: the
// [9C, ld] weights (ld = O rounded up to 8), boxes {64, 64}; both with the
// 128-byte swizzle.  `lc` = log2(cols).
template <typename T, int BN>
__global__ void __launch_bounds__(kSpecThreads, 1) conv3x3_wide_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const T* __restrict__ bias,
    T* __restrict__ y, int B, int H, int W, int C, int O, int lc) {
  using P = Wide<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t a_ring = smem_addr(base);                  // A slots
  const uint32_t b_ring = a_ring + P::kStages * P::kASlot;  // B slots
  T* stage = reinterpret_cast<T*>(base + P::kStages * P::kStageBytes);
  const uint32_t full = smem_addr(stage + 2 * 64 * P::kLDS);
  const uint32_t empty = full + 8 * P::kStages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int cols = 1 << lc, rows = P::kM >> lc;
  const int strips = (W + cols - 1) >> lc;
  const int bands = (H + rows - 1) / rows;
  const int n_tiles = (O + BN - 1) / BN;
  const long long tiles = (long long)n_tiles * strips * bands * B;
  const int slices = C / 64;
  const int ksteps = 9 * slices;

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every tile's K steps.
    regs_release();
    if (tid == kConsumerThreads) {
      int s = 0;
      uint32_t ph = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const WideTile u = wide_tile(t, n_tiles, strips, bands, rows, cols, BN);
        for (int k = 0; k < ksteps; ++k) {
          const int tap = k / slices, c0 = (k - tap * slices) * 64;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, P::kStageBytes);
          tma_load_4d(a_ring + s * P::kASlot, &xmap, full + 8 * s, c0,
                      u.x0 + tap % 3 - 1, u.y0 + tap / 3 - 1, u.b);
#pragma unroll
          for (int j = 0; j < P::kChunks; ++j)
            tma_load_2d(b_ring + (s * P::kChunks + j) * kBChunk, &wmap,
                        full + 8 * s, u.n0 + 64 * j, tap * C + c0);
          if (++s == P::kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes tile pixels kM / 2 wg .. in kMB
  // m64 blocks.
  regs_claim();
  const int wg = tid >> 7, wtid = tid & 127, lane = tid & 31;
  T* st = stage + wg * 64 * P::kLDS;
  float acc[P::kMB][BN / 2];
#pragma unroll
  for (int m = 0; m < P::kMB; ++m)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[m][j] = 0.f;
  int s = 0;
  uint32_t ph = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WideTile u = wide_tile(t, n_tiles, strips, bands, rows, cols, BN);
    int prev = 0;
    for (int k = 0; k < ksteps; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint64_t da =
          wgmma_desc(a_ring + s * P::kASlot + wg * P::kMB * 64 * 128);
      const uint64_t db = wgmma_desc_mn(b_ring + s * P::kChunks * kBChunk);
      fence_regs(acc);
      wgmma_fence();
      wide_stage<T, BN>(acc, da, db, k == 0);
      wgmma_commit();
      if (k > 0) {
        // The previous step's group is done: its stage may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == P::kStages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
#pragma unroll
    for (int m = 0; m < P::kMB; ++m)
      wide_store<T, BN>(acc[m], st, bias, y, u, H, W, O, lc,
                        (wg * P::kMB + m) * 64, 1 + wg, wtid);
  }
}

// ---------------------------------------------------------------------------
// 16-bit, 1 <= C <= 7 (rr_conv3x3): the narrow design (above)
// ---------------------------------------------------------------------------

constexpr int kNR = 8, kNC = 32;                // output rows x columns a tile
constexpr int kNHC = kNC + 2;                   // halo columns
constexpr int kNThreads = 256;                  // 8 warps, one tile row each

template <int C, int BN>
struct Narrow {
  static constexpr int kHalo = (kNR + 2) * kNHC * C;  // halo values
  // The zeroed tail that padded K columns read: a pixel sits up to
  // ((kNR - 1) kNHC + kNC - 1) C values past the halo's start.
  static constexpr int kTail = ((kNR - 1) * kNHC + kNC) * C;
  static constexpr int kHStride = kHalo + kTail;  // one halo buffer + tail
  static constexpr int kKS = (9 * C + 15) / 16;  // k16 steps
  // The k16 loop is unrolled where it is short; unrolled at KS >= 3 the
  // compiler's hoisted loads spill registers.
  static constexpr int kUnroll = kKS <= 2 ? kKS : 1;
  static constexpr int kNT = BN / 8;             // n8 tiles
  static constexpr int kLoads = (kHalo + kNThreads - 1) / kNThreads;
  static constexpr int kWOut = kNC * BN * 2;     // a warp's staged row, bytes
  static constexpr int kBFrag = kKS * kNT * 32;  // B fragments (8 bytes)
  static constexpr size_t kSmem = 1024           // base alignment
                                  + 2 * kNR * kWOut  // staging, 2 per warp
                                  + kBFrag * 8 + kKS * 16 * 4 + BN * 4 +
                                  2 * kHStride * 2;  // two halo buffers
};

// Byte offset of (pixel p, channel n) in a warp's staged row: a TMA box {BN,
// 32, 1, 1} of y, with the 128-byte swizzle at BN = 64 (16-byte chunk j of
// a 128-byte pixel row at j ^ (p % 8)) and none at BN = 8.
template <int BN>
__device__ __forceinline__ int narrow_out_offset(int p, int n) {
  const int lin = (p * BN + n) * 2;
  return BN == 64 ? lin ^ (((lin >> 7) & 7) << 4) : lin;
}

// Four 8 x 8 matrices of 16-bit values into shared memory, each lane's
// registers in the m16n8 accumulator layout (row lane / 4, columns 2 (lane %
// 4), + 1); lanes 8 i .. 8 i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0,
                                        uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// One TMA box of shared memory into a 4-D tensor map; completes as a bulk
// group of this thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read their
// shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Waits until all of this thread's bulk groups are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Tile t: image b, output rows y0 .. y0 + 7, columns x0 .. x0 + 31.  The
// order (strip fastest, then band, image) is the wrapper's plan's
// (kernels/conv3x3.py: NarrowPlan.tile).
struct NarrowTile {
  int b, y0, x0;
};

__device__ __forceinline__ NarrowTile narrow_tile(long long t, int strips,
                                                  int bands) {
  NarrowTile u;
  u.x0 = (int)(t % strips) * kNC;
  const long long q = t / strips;
  u.y0 = (int)(q % bands) * kNR;
  u.b = (int)(q / bands);
  return u;
}

// ymap: y as [B][H][W][O], boxes {BN, 32, 1, 1} (unused where O % 8 != 0).
// x and w are read as raw 16-bit values.  Grid: (persistent blocks, channel
// tiles of BN).
template <typename T, int C, int BN>
__global__ void __launch_bounds__(kNThreads, 2) conv3x3_narrow_kernel(
    const __grid_constant__ CUtensorMap ymap,
    const unsigned short* __restrict__ x, const unsigned short* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ y, int B, int H, int W,
    int O) {
  using P = Narrow<C, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* out_s =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint2* bfrag = reinterpret_cast<uint2*>(out_s + 2 * kNR * P::kWOut);
  int4* koff = reinterpret_cast<int4*>(bfrag + P::kBFrag);
  float2* bias_s = reinterpret_cast<float2*>(koff + P::kKS * 4);
  unsigned short* halo = reinterpret_cast<unsigned short*>(bias_s + BN / 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * BN;
  const bool tma = O % 8 == 0;

  // Once per block.  B fragments of the [9C, O] weights, channels n0 .. +
  // BN - 1, zero past K and past O: lane (g, t) of n8 tile nt and k16 step s
  // holds B[k][n0 + 8 nt + g] for k = 16 s + 2 t + {0, 1} and {8, 9}.
  for (int i = tid; i < P::kBFrag; i += kNThreads) {
    const int l = i & 31, nt = (i >> 5) % P::kNT, s = i / (32 * P::kNT);
    const int o = n0 + nt * 8 + (l >> 2), k = 16 * s + 2 * (l & 3);
    auto wv = [&](int kk) -> uint32_t {
      return kk < 9 * C && o < O ? w[(long long)kk * O + o] : 0u;
    };
    bfrag[i] = make_uint2(wv(k) | wv(k + 1) << 16, wv(k + 8) | wv(k + 9) << 16);
  }
  // Byte offsets into the halo of the four K columns a lane reads per k16
  // step, koff[4 s + t] = k = 16 s + 2 t + {0, 1, 8, 9}; a padded column
  // points into the zeroed tail.
  for (int i = tid; i < P::kKS * 16; i += kNThreads) {
    const int j = i & 3, k = 16 * (i >> 4) + 2 * ((i >> 2) & 3) + (j & 1) +
                             8 * (j >> 1);
    const int tap = k / C;
    reinterpret_cast<int*>(koff)[i] =
        2 * (k < 9 * C ? ((tap / 3) * kNHC + tap % 3) * C + k % C : P::kHalo);
  }
  // The bias of channel pairs (n, n + 1), fp32: each tile's sums start
  // from it.
  for (int n = 2 * tid; n < BN; n += 2 * kNThreads) {
    auto bv = [&](int o) {
      return bias != nullptr && o < O ? rr_to_float(bias[o]) : 0.f;
    };
    bias_s[n / 2] = make_float2(bv(n0 + n), bv(n0 + n + 1));
  }
  for (int i = tid; i < P::kTail; i += kNThreads)
    halo[P::kHalo + i] = halo[P::kHStride + P::kHalo + i] = 0;

  const int strips = (W + kNC - 1) / kNC;
  const int bands = (H + kNR - 1) / kNR;
  const long long tiles = (long long)B * bands * strips;

  // Halo value e of tile t (row e / (34 C), value e % (34 C) of it, from
  // pixel x0 - 1) into this thread's registers, zero outside the image;
  // the thread's j-th value in half j % 2 of pf[j / 2].
  uint32_t pf[(P::kLoads + 1) / 2];
  const long long wc = (long long)W * C;  // values in an image row
  auto fetch = [&](long long t) {
    const NarrowTile u = narrow_tile(t, strips, bands);
    // The tile's first halo value (row y0 - 1, pixel x0 - 1), as an offset
    // into x: it lies outside x at the top or left edge, but only values
    // inside the image are read.
    const long long base = ((long long)u.b * H + u.y0 - 1) * wc +
                           (long long)(u.x0 - 1) * C;
#pragma unroll
    for (int j = 0; j < P::kLoads; ++j) {
      const int e = tid + j * kNThreads;
      const int r = e / (kNHC * C), q = e - r * (kNHC * C);
      const uint32_t v =
          e < P::kHalo && (unsigned)(u.y0 - 1 + r) < (unsigned)H &&
                  (unsigned)(u.x0 - 1 + q / C) < (unsigned)W
              ? __ldg(x + (base + r * wc + q))
              : 0u;
      pf[j / 2] = j % 2 ? pf[j / 2] | v << 16 : v;
    }
  };

  // This lane's pixel g = lane / 4 of m16 tile 0 (tile row `warp`, column
  // g), as a byte offset into halo buffer 0 at dy = dx = 0.
  const unsigned char* hp = reinterpret_cast<const unsigned char*>(halo) +
                            2 * (warp * kNHC + (lane >> 2)) * C;
  // Where the accumulators land in the warp's staged row.  BN = 64: the
  // 16-byte row of 8 channels that this lane addresses for stmatrix (matrix
  // lane / 8 of the four that n8 tiles nt, nt + 1 of an m16 tile make:
  // pixel 8 (matrix % 2) + lane % 8, channel chunk nt + matrix / 2), at nt =
  // 0 with the swizzle's XOR by the pixel folded in; an even nt XORs its
  // index into bits 4-6, m16 tile 1 is 2048 bytes on.  BN = 8: this lane's
  // pair (pixel g, channels 2 t, + 1), unswizzled; pixel g + 8 is 128 bytes
  // on, m16 tile 1 256.
  const int lr = lane & 7, lm = lane >> 3;
  const int so = BN == 64
                     ? (((lm & 1) * 8 + lr) * 128) | (((lm >> 1) ^ lr) << 4)
                     : (lane >> 2) * 16 + 4 * (lane & 3);
  if (blockIdx.x < tiles) fetch(blockIdx.x);
  int i = 0;  // tiles done by this block
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const NarrowTile u = narrow_tile(t, strips, bands);
    // Halo buffer i % 2 was last read for tile i - 2, before the previous
    // tile's barrier.
    unsigned short* hb = halo + (i & 1) * P::kHStride;
#pragma unroll
    for (int j = 0; j < P::kLoads; ++j) {
      const int e = tid + j * kNThreads;
      if (e < P::kHalo) hb[e] = (unsigned short)(pf[j / 2] >> 16 * (j % 2));
    }
    __syncthreads();
    if (t + gridDim.x < tiles) fetch(t + gridDim.x);  // in flight meanwhile

    // The sums start from the bias (fp32).
    float acc[2][P::kNT][4];
#pragma unroll
    for (int nt = 0; nt < P::kNT; ++nt) {
      const float2 bv = bias_s[4 * nt + (lane & 3)];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        acc[mi][nt][0] = acc[mi][nt][2] = bv.x;
        acc[mi][nt][1] = acc[mi][nt][3] = bv.y;
      }
    }
    const unsigned char* hpb = hp + (i & 1) * 2 * P::kHStride;
#pragma unroll (P::kUnroll)
    for (int s = 0; s < P::kKS; ++s) {
      const int4 ko = koff[4 * s + (lane & 3)];
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // Rows g and g + 8 of m16 tile mi: tile columns 16 mi + g, + 8.
        const unsigned char* p = hpb + 2 * 16 * C * mi;
        const unsigned char* q = p + 2 * 8 * C;
        auto ld = [](const unsigned char* b, int off) -> uint32_t {
          return *reinterpret_cast<const unsigned short*>(b + off);
        };
        a[mi][0] = ld(p, ko.x) | ld(p, ko.y) << 16;
        a[mi][1] = ld(q, ko.x) | ld(q, ko.y) << 16;
        a[mi][2] = ld(p, ko.z) | ld(p, ko.w) << 16;
        a[mi][3] = ld(q, ko.z) | ld(q, ko.w) << 16;
      }
#pragma unroll
      for (int nt = 0; nt < P::kNT; ++nt) {
        const uint2 bv = bfrag[(s * P::kNT + nt) * 32 + lane];
        const uint32_t b[2] = {bv.x, bv.y};
        mma16816<T>(acc[0][nt], a[0], b);
        mma16816<T>(acc[1][nt], a[1], b);
      }
    }

    // The warp's row, rounded once, into its staging buffer i % 2, which
    // its store of two tiles ago must have read.
    unsigned char* ws = out_s + (2 * warp + (i & 1)) * P::kWOut;
    if (tma && lane == 0) bulk_wait_read<1>();
    __syncwarp();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if constexpr (BN == 64) {
#pragma unroll
        for (int nt = 0; nt < P::kNT; nt += 2)
          stsm_x4(smem_addr(ws) + 2048 * mi + (so ^ (nt << 4)),
                  pack2<T>(acc[mi][nt][0], acc[mi][nt][1]),
                  pack2<T>(acc[mi][nt][2], acc[mi][nt][3]),
                  pack2<T>(acc[mi][nt + 1][0], acc[mi][nt + 1][1]),
                  pack2<T>(acc[mi][nt + 1][2], acc[mi][nt + 1][3]));
      } else {
        unsigned char* d = ws + 256 * mi + so;
        *reinterpret_cast<uint32_t*>(d) =
            pack2<T>(acc[mi][0][0], acc[mi][0][1]);
        *reinterpret_cast<uint32_t*>(d + 128) =
            pack2<T>(acc[mi][0][2], acc[mi][0][3]);
      }
    }
    const int yy = u.y0 + warp;
    if (tma) {
      fence_async_shared();  // the TMA store (async proxy) reads these
      __syncwarp();
      if (lane == 0) {
        tma_store_4d(&ymap, smem_addr(ws), n0, u.x0, yy, u.b);
        bulk_commit();
      }
    } else {
      __syncwarp();
      const int oc = min(BN, O - n0), nx = min(kNC, W - u.x0);
      if (yy < H)
        for (int k = lane; k < nx * oc; k += 32) {
          const int p = k / oc, ch = k - p * oc;
          y[(((long long)u.b * H + yy) * W + u.x0 + p) * O + n0 + ch] =
              *reinterpret_cast<const T*>(ws + narrow_out_offset<BN>(p, ch));
        }
    }
  }
  // The block's shared memory must outlive the stores that read it.
  if (tma && lane == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// 16-bit, other C >= 8 (rr_conv3x3): the sliced design (above)
// ---------------------------------------------------------------------------

// Byte offset of (pixel p, channel n) in a staged output box of CW
// channels a pixel: CW 2-byte rows with TMA's swizzle of that span (bits 4
// .. of the offset XORed with bits 7 ..; none for 16-byte rows).
template <int CW>
__device__ __forceinline__ int sliced_out_offset(int p, int n) {
  const int lin = (p * CW + n) * 2;
  constexpr int mask = CW * 2 / 16 - 1;
  return CW == 8 ? lin : lin ^ (((lin >> 7) & mask) << 4);
}

// One stage's products for a warpgroup: taps dy = 0, 1, 2 of the stage's
// dx, each KS / 16 k16 steps into both m64 blocks (the sums, which start
// from the bias, accumulate).  da: the warpgroup's first pixel at dy = 0;
// tap dy starts dy x `drow` further on (a row of cols pixels, in 16-byte
// units), a k16 step 32 bytes and an m64 block 64 KS 2 bytes on.  db: the
// stage's B; tap dy starts dy kChunks kBBox bytes on, a k16 step 2048
// bytes.
template <typename T, int BN, int KS>
__device__ __forceinline__ void sliced_stage(float (&acc)[2][BN / 2],
                                             uint64_t da, uint64_t db,
                                             uint32_t drow) {
  using P = Sliced<BN, KS>;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int i = 0; i < KS / 16; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wgmma_ss<T, BN>(acc[m], da + dy * drow + m * (64 * KS * 2 / 16) + 2 * i,
                        db + dy * (P::kChunks * P::kBBox / 16) + 128 * i, 1);
}

// xmap: x as [B][H][W][C] (C % 8 = 0), boxes {KS, cols, rows + 2, 1}, the
// KS 2-byte swizzle; wmap: the weights as [9][C][ld], boxes {64, KS, 1},
// the 128-byte swizzle; ymap: y as [B][H][W][O], boxes {CW, min(cols, 64),
// 64 / min(cols, 64), 1}, swizzled by CW 2 bytes (unused where O % 8 !=
// 0).  `lc` = log2(cols); `stages` stages of `a_slot` + kBTaps bytes.
template <typename T, int BN, int KS>
__global__ void __launch_bounds__(kSpecThreads, 1) conv3x3_sliced_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const T* __restrict__ bias,
    T* __restrict__ y, int B, int H, int W, int C, int O, int lc, int stages,
    int a_slot) {
  using P = Sliced<BN, KS>;
  constexpr int CW = P::kCW;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = a_slot + P::kBTaps;
  const uint32_t ring = smem_addr(base);
  unsigned char* out_s = base + (size_t)stages * stage_bytes;
  float* bias_s = reinterpret_cast<float*>(out_s + 2 * P::kOutBoxes * P::kOutBox);
  const int n_tiles = (O + BN - 1) / BN;
  const uint32_t full = smem_addr(bias_s + n_tiles * BN);
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  // The bias in fp32, zero past O, once per block: a global load in a
  // tile's critical path waits behind the ring's traffic in L2.
  for (int i = tid; i < n_tiles * BN; i += kSpecThreads)
    bias_s[i] = bias != nullptr && i < O ? rr_to_float(bias[i]) : 0.f;
  __syncthreads();

  const int cols = 1 << lc, rows = P::kM >> lc;
  const int strips = (W + cols - 1) >> lc;
  const int bands = (H + rows - 1) / rows;
  const long long tiles = (long long)n_tiles * strips * bands * B;
  const int ksteps = 3 * ((C + KS - 1) / KS);  // k = slice 3 + dx

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every tile's stages.
    regs_release();
    if (tid == kConsumerThreads) {
      const uint32_t tx = (rows + 2) * cols * KS * 2 + P::kBTaps;
      int s = 0;
      uint32_t ph = 0;
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const WideTile u = wide_tile(t, n_tiles, strips, bands, rows, cols, BN);
        for (int k = 0; k < ksteps; ++k) {
          const int sl = k / 3, dx = k - 3 * sl;
          const uint32_t a = ring + s * stage_bytes;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, tx);
          tma_load_4d(a, &xmap, full + 8 * s, sl * KS, u.x0 + dx - 1,
                      u.y0 - 1, u.b);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int j = 0; j < P::kChunks; ++j)
              tma_load_3d(a + a_slot + (dy * P::kChunks + j) * P::kBBox, &wmap,
                          full + 8 * s, u.n0 + 64 * j, sl * KS, 3 * dy + dx);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes tile pixels 128 wg .. + 127, two
  // m64 blocks.
  regs_claim();
  const int wg = tid >> 7, wtid = tid & 127, lane = tid & 31;
  const int r = ((tid >> 5) & 3) * 16 + (lane >> 2);  // accumulator row
  const bool tma = O % 8 == 0;
  unsigned char* boxes = out_s + wg * P::kOutBoxes * P::kOutBox;
  const uint32_t drow = (uint32_t)(cols * KS * 2) >> 4;
  float acc[2][BN / 2];
  int s = 0;
  uint32_t ph = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const WideTile u = wide_tile(t, n_tiles, strips, bands, rows, cols, BN);
    // The sums start from the bias (fp32).
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int o = u.n0 + j * 8 + (lane & 3) * 2;
      const float b0 = bias_s[o], b1 = bias_s[o + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        acc[m][4 * j] = acc[m][4 * j + 2] = b0;
        acc[m][4 * j + 1] = acc[m][4 * j + 3] = b1;
      }
    }
    int prev = 0;
    for (int k = 0; k < ksteps; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * stage_bytes;
      const uint64_t da = wgmma_desc<KS * 2>(a + wg * 128 * KS * 2);
      const uint64_t db = wgmma_desc_mn(a + a_slot, P::kBBox);
      fence_regs(acc);
      wgmma_fence();
      sliced_stage<T, BN, KS>(acc, da, db, drow);
      wgmma_commit();
      if (k > 0) {
        // The previous stage's group is done: it may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // The epilogue: the warpgroup's two m64 blocks, CW channels a box,
    // rounded once into its staging boxes and stored by TMA (or by scalar
    // stores).  The boxes were last stored a tile ago: those stores must
    // have read them (and, for scalar stores, every thread copied them out).
    constexpr int NB = BN / CW;  // boxes an m64 block
    if (tma && wtid == 0) bulk_wait_read<0>();
    bar_sync_wg(1 + wg);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        unsigned char* box = boxes + (m * NB + c) * P::kOutBox;
#pragma unroll
        for (int j = 0; j < CW / 8; ++j) {
          const int col = j * 8 + (lane & 3) * 2, ai = 4 * (c * CW / 8 + j);
          *reinterpret_cast<uint32_t*>(box + sliced_out_offset<CW>(r, col)) =
              pack2<T>(acc[m][ai], acc[m][ai + 1]);
          *reinterpret_cast<uint32_t*>(box + sliced_out_offset<CW>(r + 8, col)) =
              pack2<T>(acc[m][ai + 2], acc[m][ai + 3]);
        }
      }
    if (tma) fence_async_shared();  // the TMA stores (async proxy) read them
    bar_sync_wg(1 + wg);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int p0 = (wg * 2 + m) * 64;  // the block's first tile pixel
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const unsigned char* box = boxes + (m * NB + c) * P::kOutBox;
        const int nc = u.n0 + c * CW;
        if (tma) {
          if (wtid == 0)
            tma_store_4d(&ymap, smem_addr(box), nc, u.x0 + (p0 & (cols - 1)),
                         u.y0 + (p0 >> lc), u.b);
        } else {
          for (int i = wtid; i < 64 * CW; i += 128) {
            const int px = i / CW, ch = i % CW, p = p0 + px;
            const int yy = u.y0 + (p >> lc), xx = u.x0 + (p & (cols - 1));
            if (yy < H && xx < W && nc + ch < O)
              y[(((long long)u.b * H + yy) * W + xx) * O + nc + ch] =
                  *reinterpret_cast<const T*>(box +
                                              sliced_out_offset<CW>(px, ch));
          }
        }
      }
    }
    if (tma && wtid == 0) bulk_commit();
  }
  // The block's shared memory must outlive the stores that read it.
  if (tma && wtid == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// fp32 (both entry points): the split-TF32 design (above)
// ---------------------------------------------------------------------------

// Tiles of 256 pixels x N channels, K slices of KS fp32 channels (kS bytes
// a pixel, the swizzle span).  A stage: the box of x, a box of its lo
// (a_slot bytes each, set at launch), then the weights' boxes {KS c, N o}:
// hi of taps dy = 0, 1, 2, then lo of the same, each on a 1024-byte
// boundary.  Three TF32 passes: x_hi w_hi + x_hi w_lo + x_lo w_hi,
// fp32-accurate.
template <int N, int KS>
struct Tf32 {
  static constexpr int kM = 256;
  static constexpr int kS = KS * 4;
  static constexpr int kABoxes = 2;  // x and its lo
  static constexpr int kPlanes = 2;  // w's hi and lo
  static constexpr int kBBox = (N * KS * 4 + 1023) / 1024 * 1024;
  static constexpr int kBBytes = 3 * kPlanes * kBBox;
  static constexpr int kBTx = 3 * kPlanes * N * KS * 4;  // what TMA writes
};

// ws [2][9][O][Cp] (hi, lo; tap, output channel, input channel; zero past
// C) from the HWIO weights w [9][C][O]; for one pass (passes = 1) ws
// [9][O][Cp], w rounded to TF32.  Also zeroes the `ncnt` counters of a
// split call (split_sum) before the conv kernel, next on the stream,
// counts on them.
__global__ void conv3x3_tf32_split_kernel(const float* __restrict__ w,
                                          float* __restrict__ ws, int C,
                                          int Cp, int O, int passes,
                                          int* __restrict__ cnt,
                                          long long ncnt) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < ncnt; i += (long long)gridDim.x * blockDim.x)
    cnt[i] = 0;
  const long long n = 9LL * Cp * O;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int o = (int)(i % O);
    const long long q = i / O;
    const int c = (int)(q % Cp), tap = (int)(q / Cp);
    const long long d = ((long long)tap * O + o) * Cp + c;
    if (passes == 1) {
      ws[d] = c < C ? tf32_round_w(w[((long long)tap * C + c) * O + o]) : 0.f;
      continue;
    }
    float hi = 0.f, lo = 0.f;
    if (c < C) tf32_split_w(w[((long long)tap * C + c) * O + o], hi, lo);
    ws[d] = hi;
    ws[n + d] = lo;
  }
}

// One pass: 16-byte chunks [i0, i1) of a landed box of x rounded to
// nearest TF32 in place by the 128 threads of a warpgroup (`wtid` its
// thread).  Each chunk is four channels of one pixel, so the swizzle does
// not matter.  One chunk at a time: loading ten before storing any was
// 0.25 ms slower at [16,640,640,64] -> 64 (scripts/probe_tf32_conv.py
// x1_no_store; NVIDIA H100 80GB HBM3 at 700 W), the rounding's bursts
// competing with the wgmmas' operand reads.
__device__ __forceinline__ void round_box_x(uint4* xv, int i0, int i1,
                                            int wtid) {
  for (int i = i0 + wtid; i < i1; i += 128) {
    const uint4 v = xv[i];
    xv[i] = make_uint4(tf32_round_x(v.x), tf32_round_x(v.y),
                       tf32_round_x(v.z), tf32_round_x(v.w));
  }
}

// A stage's products for a warpgroup: taps dy = 0, 1, 2, each KS / 8 k8
// steps into both m64 blocks, as x_hi w_hi into acc and x_hi w_lo + x_lo
// w_hi into cor.  da:
// the warpgroup's first pixel at dy = 0 in the box of x; tap dy starts dy x
// `drow` further on (a row of cols pixels, in 16-byte units), a k8 step 32
// bytes and an m64 block 64 kS bytes on; the box of lo is `dlo` further on.
// db: the stage's weights, tap dy's hi box dy kBBox bytes on, its lo box 3
// kBBox further.
template <int N, int KS>
__device__ __forceinline__ void tf32x3_stage(float (&acc)[2][N / 2],
                                             float (&cor)[2][N / 2],
                                             uint64_t da, uint64_t db,
                                             uint32_t drow, uint32_t dlo) {
  using P = Tf32<N, KS>;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int i = 0; i < KS / 8; ++i)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const uint64_t ah = da + dy * drow + m * (64 * P::kS / 16) + 2 * i;
        const uint64_t bh = db + dy * (P::kBBox / 16) + 2 * i;
        const uint64_t bl = bh + 3 * (P::kBBox / 16);
        wgmma_ss<float, N>(acc[m], ah, bh, 1);
        wgmma_ss<float, N>(cor[m], ah, bl, 1);
        wgmma_ss<float, N>(cor[m], ah + dlo, bh, 1);
      }
}

// xmap: x as [B][H][W][Cp] fp32, boxes {KS, cols, rows + 2, 1}; wmap: ws as
// [18][O][Cp], boxes {KS, N, 1}; both with the kS-byte swizzle.
// `lc` = log2(cols); `stages` stages of kABoxes `a_slot` + kBBytes bytes.
// `splits` K splits a tile (split_sum's workspace `part` and counters
// `cnt`) in the kSplit instances; the others take whole tiles (splits =
// 1) in the code of an unsplit walk (the header's split-K paragraph).
template <int N, int KS, bool kSplit>
__global__ void __launch_bounds__(kSpecThreads, 1) conv3x3_tf32x3_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
    float* __restrict__ y, float* __restrict__ part, int* __restrict__ cnt,
    int B, int H, int W, int Cp, int O, int lc, int stages, int a_slot,
    int splits) {
  using P = Tf32<N, KS>;
  static_assert(KS == 8 || KS == 16, "K slice");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = P::kABoxes * a_slot + P::kBBytes;
  const uint32_t ring = smem_addr(base);
  float* bias_s = reinterpret_cast<float*>(base + (size_t)stages * stage_bytes);
  const int n_tiles = (O + N - 1) / N;
  const uint32_t full = smem_addr(bias_s + n_tiles * N);
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  for (int i = tid; i < n_tiles * N; i += kSpecThreads)
    bias_s[i] = bias != nullptr && i < O ? bias[i] : 0.f;
  __syncthreads();

  const int cols = 1 << lc, rows = P::kM >> lc;
  const int strips = (W + cols - 1) >> lc;
  const int bands = (H + rows - 1) / rows;
  if (!kSplit) splits = 1;
  const long long units = (long long)n_tiles * strips * bands * B * splits;
  const int slices = (Cp + KS - 1) / KS;  // stage k = slice 3 + dx
  const int box_bytes = (rows + 2) * cols * P::kS;

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every unit's stages.
    regs_release();
    if (tid == kConsumerThreads) {
      const uint32_t tx = box_bytes + P::kBTx;
      int s = 0;
      uint32_t ph = 0;
      for (long long i = blockIdx.x; i < units; i += gridDim.x) {
        const SplitUnit<kSplit> q(i, splits, slices);
        const WideTile u = wide_tile(q.t, n_tiles, strips, bands, rows, cols,
                                     N);
        for (int k = q.k0; k < q.k1; ++k) {
          const int sl = k / 3, dx = k - 3 * sl;
          const uint32_t a = ring + s * stage_bytes;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, tx);
          tma_load_4d(a, &xmap, full + 8 * s, sl * KS, u.x0 + dx - 1,
                      u.y0 - 1, u.b);
#pragma unroll
          for (int p = 0; p < P::kPlanes; ++p)
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
              tma_load_3d(a + P::kABoxes * a_slot + (3 * p + dy) * P::kBBox,
                          &wmap, full + 8 * s, sl * KS, u.n0,
                          9 * p + 3 * dy + dx);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes tile pixels 128 wg .. + 127, two
  // m64 blocks.
  regs_claim();
  const int wg = tid >> 7, lane = tid & 31;
  const int r = ((tid >> 5) & 3) * 16 + (lane >> 2);  // accumulator row
  const uint32_t drow = (uint32_t)(cols * P::kS) >> 4;
  const uint32_t dlo = (uint32_t)a_slot >> 4;
  // acc: x_hi w_hi from the bias (split 0; the other splits from 0); cor:
  // the corrections.
  float acc[2][N / 2], cor[2][N / 2];
  int s = 0;
  uint32_t ph = 0;
  for (long long i = blockIdx.x; i < units; i += gridDim.x) {
    const SplitUnit<kSplit> q(i, splits, slices);
    const int k0 = q.k0, k1 = q.k1;
    const WideTile u = wide_tile(q.t, n_tiles, strips, bands, rows, cols, N);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int o = u.n0 + j * 8 + (lane & 3) * 2;
      const float b0 = q.sp ? 0.f : bias_s[o];
      const float b1 = q.sp ? 0.f : bias_s[o + 1];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        acc[m][4 * j] = acc[m][4 * j + 2] = b0;
        acc[m][4 * j + 1] = acc[m][4 * j + 3] = b1;
#pragma unroll
        for (int e = 0; e < 4; ++e) cor[m][4 * j + e] = 0.f;
      }
    }
    int prev = 0;
    for (int k = k0; k < k1; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * stage_bytes;
      // The box as it lies is x_hi (wgmma reads fp32 truncated to TF32).
      // Both warpgroups write its lo into the second box, chunk by chunk at
      // the same offsets (so with the same swizzle).  Then they meet.
      {
        uint4* xv = reinterpret_cast<uint4*>(base + (a - ring));
        uint4* lv = reinterpret_cast<uint4*>(base + (a - ring) + a_slot);
        for (int i = tid; i < box_bytes / 16; i += kConsumerThreads) {
          const uint4 v = xv[i];
          lv[i] = make_uint4(tf32_lo(v.x), tf32_lo(v.y), tf32_lo(v.z),
                             tf32_lo(v.w));
        }
        fence_async_shared();  // the generic writes, before wgmma reads them
        bar_sync_consumers();
      }
      const uint64_t da = wgmma_desc<P::kS>(a + wg * 128 * P::kS);
      const uint64_t db = wgmma_desc<P::kS>(a + P::kABoxes * a_slot);
      fence_regs(acc);
      fence_regs(cor);
      wgmma_fence();
      tf32x3_stage<N, KS>(acc, cor, da, db, drow, dlo);
      wgmma_commit();
      if (k > k0) {
        // The previous stage's group is done: it may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        fence_regs(cor);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(cor);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) acc[m][e] += cor[m][e];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    if constexpr (kSplit) {
      if (!split_sum(acc, part, cnt, q.t, wg, q.sp, splits, tid & 127))
        continue;  // another unit of the tile finishes it
    }

    // The epilogue: accumulator pairs (columns 8 j + 2 (lane % 4), + 1) of
    // rows r and r + 8 of each m64 block, straight to y.
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = 128 * wg + 64 * m + r + 8 * h;  // the tile pixel
        const int yy = u.y0 + (p >> lc), xx = u.x0 + (p & (cols - 1));
        if (yy >= H || xx >= W) continue;
        float* dst = y + (((long long)u.b * H + yy) * W + xx) * O;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int o = u.n0 + j * 8 + (lane & 3) * 2;
          const float v0 = acc[m][4 * j + 2 * h], v1 = acc[m][4 * j + 2 * h + 1];
          if (O % 2 == 0) {
            if (o < O) *reinterpret_cast<float2*>(dst + o) = make_float2(v0, v1);
          } else {
            if (o < O) dst[o] = v0;
            if (o + 1 < O) dst[o + 1] = v1;
          }
        }
      }
  }
}

// ---------------------------------------------------------------------------
// fp32, one TF32 pass, O > 32 (rr_conv3x3 with passes = 1 and R > 0): the
// one-pass design (above)
// ---------------------------------------------------------------------------

// Tiles of kM = 2 NPX pixels x MB 64 output channels, K slices of KS fp32
// channels (kS bytes a pixel, the swizzle span).  A stage: the box of x
// (a_slot bytes, set at launch), then the weights' boxes {KS c, 64 o} of
// taps dy = 0, 1, 2, MB blocks each.  The epilogue stages kCPX pixels x MB
// 64 channels at a time per warpgroup, as 2 MB output boxes of kCPX pixels
// x 32 channels (kBox bytes, the 128-byte swizzle), in two buffers.
template <int MB, int NPX, int KS>
struct Tf32x1 {
  static_assert((MB == 1 && (NPX == 128 || NPX == 256)) ||
                    (MB == 2 && NPX == 128),
                "tile shape");
  static_assert(KS == 8 || KS == 16, "K slice");
  static constexpr int kM = 2 * NPX;
  static constexpr int kBN = 64 * MB;
  static constexpr int kS = KS * 4;
  static constexpr int kABox = 64 * KS * 4;
  static constexpr int kABytes = 3 * MB * kABox;
  static constexpr int kCPX = 32 / MB;
  static constexpr int kBox = kCPX * 32 * 4;
  static constexpr int kChunk = 2 * MB * kBox;  // 8 KB
  static constexpr int kOut = 2 * kChunk;       // a warpgroup's two buffers
};

// Byte offset of (pixel p, channel n) in an output box of 32 fp32
// channels a pixel: 128-byte rows with TMA's 128-byte swizzle (16-byte
// chunk n / 4 of row p at chunk n / 4 ^ p % 8).
__device__ __forceinline__ int x1_out_offset(int p, int n) {
  return p * 128 + ((((n >> 2) ^ p) & 7) << 4) + ((n & 3) << 2);
}

// A stage's products for a warpgroup: taps dy = 0, 1, 2, each KS / 8 k8
// steps into each of its MB m64 blocks of output channels, over its NPX
// pixels.  da: the stage's weights, tap dy's block m (dy MB + m) kABox bytes
// on, a k8 step 32 bytes; db: the warpgroup's first pixel at dy = 0 in the
// box of x, tap dy `drow` further on (a row of cols pixels, in 16-byte
// units), a k8 step 32 bytes.
template <int MB, int NPX, int KS>
__device__ __forceinline__ void tf32x1_stage(float (&acc)[MB][NPX / 2],
                                             uint64_t da, uint64_t db,
                                             uint32_t drow) {
  using P = Tf32x1<MB, NPX, KS>;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int i = 0; i < KS / 8; ++i)
#pragma unroll
      for (int m = 0; m < MB; ++m)
        wgmma_ss<float, NPX>(acc[m],
                             da + (dy * MB + m) * (P::kABox / 16) + 2 * i,
                             db + dy * drow + 2 * i, 1);
}

// The one-pass kernel.  xmap: x [B][H][W][Cp] fp32, boxes {KS, cols, rows
// + 2, 1}; wmap: ws [9][O][Cp] (the weights rounded to TF32), boxes {KS,
// 64, 1}; both with the kS-byte swizzle; ymap: y [B][H][W][O], boxes {32,
// min(cols, kCPX), kCPX / min(cols, kCPX), 1}, the 128-byte swizzle
// (unused where O % 4 != 0).  `lc` = log2(cols); `stages` stages of
// `a_slot` + kABytes bytes; `splits` K splits a tile (split_sum's
// workspace `part` and counters `cnt`) in the kSplit instances, whole
// tiles in the others (as conv3x3_tf32x3_kernel).
template <int MB, int NPX, int KS, bool kSplit>
__global__ void __launch_bounds__(kSpecThreads, 1) conv3x3_tf32x1_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap ymap, const float* __restrict__ bias,
    float* __restrict__ y, float* __restrict__ part, int* __restrict__ cnt,
    int B, int H, int W, int Cp, int O, int lc, int stages, int a_slot,
    int splits) {
  using P = Tf32x1<MB, NPX, KS>;
  constexpr int BN = P::kBN;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const int stage_bytes = a_slot + P::kABytes;
  const uint32_t ring = smem_addr(base);
  unsigned char* out_s = base + (size_t)stages * stage_bytes;
  float* bias_s = reinterpret_cast<float*>(out_s + 2 * P::kOut);
  const int n_tiles = (O + BN - 1) / BN;
  const uint32_t full = smem_addr(bias_s + n_tiles * BN);
  const uint32_t empty = full + 8 * stages;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumerThreads / 32);
    }
    fence_barrier_init();
  }
  for (int i = tid; i < n_tiles * BN; i += kSpecThreads)
    bias_s[i] = bias != nullptr && i < O ? bias[i] : 0.f;
  __syncthreads();

  const int cols = 1 << lc, rows = P::kM >> lc;
  const int strips = (W + cols - 1) >> lc;
  const int bands = (H + rows - 1) / rows;
  if (!kSplit) splits = 1;
  const long long units = (long long)n_tiles * strips * bands * B * splits;
  const int slices = (Cp + KS - 1) / KS;  // stage k = slice 3 + dx
  const int box_bytes = (rows + 2) * cols * P::kS;

  if (tid >= kConsumerThreads) {
    // The producer warpgroup: one thread streams every unit's stages.
    regs_release();
    if (tid == kConsumerThreads) {
      const uint32_t tx = box_bytes + P::kABytes;
      int s = 0;
      uint32_t ph = 0;
      for (long long i = blockIdx.x; i < units; i += gridDim.x) {
        const SplitUnit<kSplit> q(i, splits, slices);
        const WideTile u = wide_tile(q.t, n_tiles, strips, bands, rows, cols,
                                     BN);
        for (int k = q.k0; k < q.k1; ++k) {
          const int sl = k / 3, dx = k - 3 * sl;
          const uint32_t a = ring + s * stage_bytes;
          mbar_wait(empty + 8 * s, ph ^ 1);
          mbar_expect_tx(full + 8 * s, tx);
          tma_load_4d(a, &xmap, full + 8 * s, sl * KS, u.x0 + dx - 1,
                      u.y0 - 1, u.b);
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int m = 0; m < MB; ++m)
              tma_load_3d(a + a_slot + (dy * MB + m) * P::kABox, &wmap,
                          full + 8 * s, sl * KS, u.n0 + 64 * m, 3 * dy + dx);
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // The consumers: warpgroup wg computes tile pixels NPX wg .. + NPX - 1
  // (wgmma's N) for every channel of the tile (MB m64 blocks: wgmma's M).
  regs_claim();
  const int wg = tid >> 7, wtid = tid & 127, lane = tid & 31;
  const int orow = ((tid >> 5) & 3) * 16 + (lane >> 2);  // accumulator row
  const int pcol = 2 * (lane & 3);  // its first column of each 8 pixels
  const uint32_t drow = (uint32_t)(cols * P::kS) >> 4;
  // The box pixels this warpgroup's taps read, in 16-byte chunks.
  const int r0 = NPX * wg * P::kS / 16;
  const int r1 = (NPX * (wg + 1) + 2 * cols) * P::kS / 16;
  unsigned char* st = out_s + wg * P::kOut;
  const bool tma = O % 4 == 0;  // a tensor map over y needs 16-byte pixels
  float acc[MB][NPX / 2];
  int s = 0;
  uint32_t ph = 0;
  for (long long i = blockIdx.x; i < units; i += gridDim.x) {
    const SplitUnit<kSplit> q(i, splits, slices);
    const int k0 = q.k0, k1 = q.k1;
    const WideTile u = wide_tile(q.t, n_tiles, strips, bands, rows, cols, BN);
    // The sums start from the bias of their rows' output channels (split
    // 0; the other splits from 0).
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const float b0 = q.sp ? 0.f : bias_s[u.n0 + 64 * m + orow];
      const float b1 = q.sp ? 0.f : bias_s[u.n0 + 64 * m + orow + 8];
#pragma unroll
      for (int j = 0; j < NPX / 8; ++j) {
        acc[m][4 * j] = acc[m][4 * j + 1] = b0;
        acc[m][4 * j + 2] = acc[m][4 * j + 3] = b1;
      }
    }
    int prev = 0;
    for (int k = k0; k < k1; ++k) {
      mbar_wait(full + 8 * s, ph);
      const uint32_t a = ring + s * stage_bytes;
      // Round the box pixels this warpgroup's taps read, in place, and
      // wait for this warpgroup's own warps alone: the other warpgroup's
      // products run meanwhile.  The 2 cols pixels both read may be
      // written twice, with the same bits.
      round_box_x(reinterpret_cast<uint4*>(base + (a - ring)), r0, r1, wtid);
      fence_async_shared();  // the generic writes, before wgmma reads them
      bar_sync_wg(1 + wg);
      const uint64_t da = wgmma_desc<P::kS>(a + a_slot);
      const uint64_t db = wgmma_desc<P::kS>(a + wg * NPX * P::kS);
      fence_regs(acc);
      wgmma_fence();
      tf32x1_stage<MB, NPX, KS>(acc, da, db, drow);
      wgmma_commit();
      if constexpr (kSplit && MB == 1) {
        // This stage's group done, before the loop's back edge: with a
        // group in flight across it, ptxas serialized these instances'
        // wgmmas (note C7515: non-wgmma instructions defining the
        // accumulators within a pipeline stage), as it did the rows
        // kernel's split instances.
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      } else if (k > k0) {
        // The previous stage's group is done: it may be refilled.
        wgmma_wait<1>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (!(kSplit && MB == 1) && lane == 0) mbar_arrive(empty + 8 * prev);
    if constexpr (kSplit) {
      if (!split_sum(acc, part, cnt, q.t, wg, q.sp, splits, wtid))
        continue;  // another unit of the tile finishes it
    }

    // The epilogue.  The sums lie [channel][pixel] (thread: channels orow,
    // orow + 8 of each block, pixels 8 j + pcol, + 1); y wants channels
    // contiguous.  kCPX pixels at a time go into one of the warpgroup's two
    // buffers as 2 MB output boxes [pixel][32 channels] (the 128-byte
    // swizzle: a warp's 32 writes fall in 32 banks), and one thread stores
    // them with TMA: the hardware drops what falls past the image or O,
    // and the stores drain while the next chunk is staged and the next
    // tile's products run.  A buffer is rewritten two chunks later, once
    // cp.async.bulk.wait_group.read says its stores have read it.  O % 4 !=
    // 0: coalesced scalar stores from the same boxes.
#pragma unroll
    for (int c = 0; c < NPX / P::kCPX; ++c) {
      unsigned char* buf = st + (c & 1) * P::kChunk;
      if (tma && wtid == 0) bulk_wait_read<1>();
      bar_sync_wg(1 + wg);  // the buffer's last readers are done
#pragma unroll
      for (int jj = 0; jj < P::kCPX / 8; ++jj)
#pragma unroll
        for (int m = 0; m < MB; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int oc = 64 * m + orow + 8 * h;  // the tile's channel
              *reinterpret_cast<float*>(
                  buf + (oc >> 5) * P::kBox +
                  x1_out_offset(8 * jj + pcol + e, oc & 31)) =
                  acc[m][4 * (c * (P::kCPX / 8) + jj) + 2 * h + e];
            }
      if (tma) fence_async_shared();  // the TMA stores (async proxy) read it
      bar_sync_wg(1 + wg);
      const int q0 = NPX * wg + P::kCPX * c;  // the chunk's first tile pixel
      if (tma) {
        if (wtid == 0) {
#pragma unroll
          for (int bx = 0; bx < 2 * MB; ++bx)
            tma_store_4d(&ymap, smem_addr(buf + bx * P::kBox),
                         u.n0 + 32 * bx, u.x0 + (q0 & (cols - 1)),
                         u.y0 + (q0 >> lc), u.b);
          bulk_commit();
        }
      } else {
        for (int i = wtid; i < P::kCPX * BN; i += 128) {
          const int px = i / BN, oc = i % BN, q = q0 + px;
          const int yy = u.y0 + (q >> lc), xx = u.x0 + (q & (cols - 1));
          const int o = u.n0 + oc;
          if (yy < H && xx < W && o < O)
            y[(((long long)u.b * H + yy) * W + xx) * O + o] =
                *reinterpret_cast<const float*>(
                    buf + (oc >> 5) * P::kBox + x1_out_offset(px, oc & 31));
        }
      }
    }
  }
  // The block's shared memory must outlive the stores that read it.
  if (tma && wtid == 0) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// The streamed C = 64 kernel: `grid` persistent blocks per tile of BN output
// channels, bands of R rows.
template <typename T, int BN>
cudaError_t launch_stream(const void* x, const void* w, const void* b, void* y,
                          int B, int H, int W, int O, int R, int grid,
                          cudaStream_t st) {
  CUtensorMap map;
  const cuuint64_t dims[4] = {(cuuint64_t)kC, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {kC * 2ull, kC * 2ull * W, kC * 2ull * W * H};
  const cuuint32_t box[4] = {(cuuint32_t)kC, (cuuint32_t)kBoxPix, 1, 1};
  cudaError_t e = encode_map<T>(&map, x, 4, dims, strides, box);
  if (e != cudaSuccess) return e;
  constexpr size_t bytes = stream_smem_bytes<BN>();
  // Above 48 KB a block gets dynamic shared memory only after this call
  // (on the current device); without it the launch is refused.
  e = cudaFuncSetAttribute(conv3x3_stream_kernel<T, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 g((unsigned)grid, (unsigned)((O + BN - 1) / BN));
  conv3x3_stream_kernel<T, BN><<<g, kSpecThreads, bytes, st>>>(
      map, static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), B, H, W, O, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t stream(const void* x, const void* w, const void* b, void* y, int B,
                   int H, int W, int O, int R, int grid, cudaStream_t st) {
  if (R <= 0 || grid <= 0) return cudaErrorInvalidValue;
  if (O <= 8) return launch_stream<T, 8>(x, w, b, y, B, H, W, O, R, grid, st);
  if (O <= 16) return launch_stream<T, 16>(x, w, b, y, B, H, W, O, R, grid, st);
  if (O <= 32) return launch_stream<T, 32>(x, w, b, y, B, H, W, O, R, grid, st);
  return launch_stream<T, 64>(x, w, b, y, B, H, W, O, R, grid, st);
}

// The wide kernel: `grid` persistent blocks over tiles of Wide<BN>::kM
// pixels (cols = 1 << lc wide) x BN output channels.  w is [9C, ld] with ld = O
// rounded up to 8 (the wrapper's zero-padded copy where O % 8 != 0).
template <typename T, int BN>
cudaError_t launch_wide(const void* x, const void* w, const void* b, void* y,
                        int B, int H, int W, int C, int O, int lc, int grid,
                        cudaStream_t st) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {C * 2ull, C * 2ull * W, C * 2ull * W * H};
  const cuuint32_t xb[4] = {64, 1u << lc, (cuuint32_t)(Wide<BN>::kM >> lc),
                            1};
  cudaError_t e = encode_map<T>(&xmap, x, 4, xd, xs, xb);
  if (e != cudaSuccess) return e;
  const cuuint64_t ld = (cuuint64_t)(O + 7) / 8 * 8;
  const cuuint64_t wd[2] = {ld, 9ull * C};
  const cuuint64_t ws[1] = {ld * 2};
  const cuuint32_t wb[2] = {64, 64};
  e = encode_map<T>(&wmap, w, 2, wd, ws, wb);
  if (e != cudaSuccess) return e;
  constexpr size_t bytes = Wide<BN>::kSmem;
  e = cudaFuncSetAttribute(conv3x3_wide_kernel<T, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  conv3x3_wide_kernel<T, BN><<<grid, kSpecThreads, bytes, st>>>(
      xmap, wmap, static_cast<const T*>(b), static_cast<T*>(y), B, H, W, C, O,
      lc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t wide(const void* x, const void* w, const void* b, void* y, int B,
                 int H, int W, int C, int O, int cols, int n, int grid,
                 cudaStream_t st) {
  const int lc = cols == 16 ? 4 : cols == 32 ? 5 : cols == 64 ? 6
               : cols == 128 ? 7 : -1;
  if (lc < 0 || grid <= 0) return cudaErrorInvalidValue;
  switch (n) {
    case 8: return launch_wide<T, 8>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    case 16: return launch_wide<T, 16>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    case 32: return launch_wide<T, 32>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    case 64: return launch_wide<T, 64>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    case 128: return launch_wide<T, 128>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    case 256: return launch_wide<T, 256>(x, w, b, y, B, H, W, C, O, lc, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// The narrow kernel: `grid` persistent blocks per tile of BN output
// channels.  Where O % 8 = 0 the output goes out through a tensor map of
// y, boxes {BN, 32, 1, 1} (the 128-byte swizzle at BN = 64).
template <typename T, int C, int BN>
cudaError_t launch_narrow(const void* x, const void* w, const void* b,
                          void* y, int B, int H, int W, int O, int grid,
                          cudaStream_t st) {
  CUtensorMap map = {};
  cudaError_t e;
  if (O % 8 == 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)O, (cuuint64_t)W, (cuuint64_t)H,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {O * 2ull, O * 2ull * W, O * 2ull * W * H};
    const cuuint32_t box[4] = {(cuuint32_t)BN, kNC, 1, 1};
    e = encode_map<T>(&map, y, 4, dims, strides, box, swizzle_of(BN * 2));
    if (e != cudaSuccess) return e;
  }
  constexpr size_t bytes = Narrow<C, BN>::kSmem;
  e = cudaFuncSetAttribute(conv3x3_narrow_kernel<T, C, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 g((unsigned)grid, (unsigned)((O + BN - 1) / BN));
  conv3x3_narrow_kernel<T, C, BN><<<g, kNThreads, bytes, st>>>(
      map, static_cast<const unsigned short*>(x),
      static_cast<const unsigned short*>(w), static_cast<const T*>(b),
      static_cast<T*>(y), B, H, W, O);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t narrow_c(const void* x, const void* w, const void* b, void* y,
                     int B, int H, int W, int C, int O, int grid,
                     cudaStream_t st) {
  switch (C) {
    case 1: return launch_narrow<T, 1, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 2: return launch_narrow<T, 2, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 3: return launch_narrow<T, 3, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 4: return launch_narrow<T, 4, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 5: return launch_narrow<T, 5, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 6: return launch_narrow<T, 6, BN>(x, w, b, y, B, H, W, O, grid, st);
    case 7: return launch_narrow<T, 7, BN>(x, w, b, y, B, H, W, O, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t narrow(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, int C, int O, int n, int grid,
                   cudaStream_t st) {
  if (grid <= 0) return cudaErrorInvalidValue;
  if (n == 8) return narrow_c<T, 8>(x, w, b, y, B, H, W, C, O, grid, st);
  if (n == 64) return narrow_c<T, 64>(x, w, b, y, B, H, W, C, O, grid, st);
  return cudaErrorInvalidValue;
}

// The sliced kernel: `grid` persistent blocks over tiles of 256 pixels
// (cols = 1 << lc wide) x BN output channels, K slices of KS.  x is
// [B,H,W,C] and w [3,3,C,ld], C % 8 = 0, ld = O rounded up to 8.  The ring
// takes as many stages as fit beside the output boxes and the bias (O
// rounded up to BN floats), at most kSlicedMaxStages; fewer than two (O
// beyond about 30000) is refused.
template <typename T, int BN, int KS>
cudaError_t launch_sliced(const void* x, const void* w, const void* b,
                          void* y, int B, int H, int W, int C, int O, int lc,
                          int grid, cudaStream_t st) {
  using P = Sliced<BN, KS>;
  const int cols = 1 << lc, rows = P::kM >> lc;
  CUtensorMap xmap, wmap, ymap = {};
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {C * 2ull, C * 2ull * W, C * 2ull * W * H};
  const cuuint32_t xb[4] = {(cuuint32_t)KS, (cuuint32_t)cols,
                            (cuuint32_t)(rows + 2), 1};
  cudaError_t e = encode_map<T>(&xmap, x, 4, xd, xs, xb, swizzle_of(KS * 2));
  if (e != cudaSuccess) return e;
  const cuuint64_t ld = (cuuint64_t)(O + 7) / 8 * 8;
  const cuuint64_t wd[3] = {ld, (cuuint64_t)C, 9};
  const cuuint64_t ws[2] = {ld * 2, ld * 2 * C};
  const cuuint32_t wb[3] = {64, (cuuint32_t)KS, 1};
  e = encode_map<T>(&wmap, w, 3, wd, ws, wb);
  if (e != cudaSuccess) return e;
  if (O % 8 == 0) {
    const int bc = cols < 64 ? cols : 64;
    const cuuint64_t yd[4] = {(cuuint64_t)O, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
    const cuuint64_t ys[3] = {O * 2ull, O * 2ull * W, O * 2ull * W * H};
    const cuuint32_t yb[4] = {(cuuint32_t)P::kCW, (cuuint32_t)bc,
                              (cuuint32_t)(64 / bc), 1};
    e = encode_map<T>(&ymap, y, 4, yd, ys, yb, swizzle_of(P::kCW * 2));
    if (e != cudaSuccess) return e;
  }
  const int a_slot = ((rows + 2) * cols * KS * 2 + 1023) / 1024 * 1024;
  const int stage = a_slot + P::kBTaps;
  const int fixed = P::kFixed + (O + BN - 1) / BN * BN * 4;  // + the bias
  const int stages =
      std::min(kSlicedMaxStages, (kSmemMax - fixed) / (stage + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t bytes = fixed + (size_t)stages * (stage + 16);
  e = cudaFuncSetAttribute(conv3x3_sliced_kernel<T, BN, KS>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  conv3x3_sliced_kernel<T, BN, KS><<<grid, kSpecThreads, bytes, st>>>(
      xmap, wmap, ymap, static_cast<const T*>(b), static_cast<T*>(y), B, H, W,
      C, O, lc, stages, a_slot);
  return cudaGetLastError();
}

template <typename T, int BN>
cudaError_t sliced_ks(const void* x, const void* w, const void* b, void* y,
                      int B, int H, int W, int C, int O, int lc, int ks,
                      int grid, cudaStream_t st) {
  if (ks == 16)
    return launch_sliced<T, BN, 16>(x, w, b, y, B, H, W, C, O, lc, grid, st);
  if (ks == 32)
    return launch_sliced<T, BN, 32>(x, w, b, y, B, H, W, C, O, lc, grid, st);
  return cudaErrorInvalidValue;
}

// C is the caller's channel count; where C % 8 != 0, x and w hold C
// rounded up to the K slice (the wrapper's zero-padded copies).
template <typename T>
cudaError_t sliced(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, int C, int O, int cols, int n, int ks,
                   int grid, cudaStream_t st) {
  const int lc = cols == 16 ? 4 : cols == 32 ? 5 : cols == 64 ? 6
               : cols == 128 ? 7 : -1;
  if (lc < 0 || grid <= 0 || ks <= 0) return cudaErrorInvalidValue;
  const int cx = C % 8 ? (C + ks - 1) / ks * ks : C;  // x's channels
  switch (n) {
    case 8: return sliced_ks<T, 8>(x, w, b, y, B, H, W, cx, O, lc, ks, grid, st);
    case 16: return sliced_ks<T, 16>(x, w, b, y, B, H, W, cx, O, lc, ks, grid, st);
    case 32: return sliced_ks<T, 32>(x, w, b, y, B, H, W, cx, O, lc, ks, grid, st);
    case 64: return sliced_ks<T, 64>(x, w, b, y, B, H, W, cx, O, lc, ks, grid, st);
    case 128: return sliced_ks<T, 128>(x, w, b, y, B, H, W, cx, O, lc, ks, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

// The split-TF32 kernel: `grid` persistent blocks over units of tiles of
// 256 pixels (cols = 1 << lc wide) x N output channels and `splits` K
// splits a tile, K slices of KS.  x is [B,H,W,Cp] (Cp = C rounded up to 4:
// the wrapper's zero-padded copy where C % 4 != 0), w the caller's
// [3,3,C,O]; ws, the wrapper's scratch of 18 O Cp floats, takes the
// weights' split first, then, where splits > 1, the split workspace
// (split_space).  The ring takes as many stages as fit beside the bias,
// at most kSlicedMaxStages.
template <int N, int KS>
cudaError_t launch_tf32x3(const void* x, const void* w, const void* b,
                          void* y, void* ws, int B, int H, int W, int C,
                          int O, int lc, int grid, int splits,
                          cudaStream_t st) {
  using P = Tf32<N, KS>;
  const int cols = 1 << lc, rows = P::kM >> lc, cp = (C + 3) / 4 * 4;
  const long long nw = 9LL * cp * O;
  const long long tiles = (long long)((O + N - 1) / N) * ((W + cols - 1) / cols)
                          * ((H + rows - 1) / rows) * B;
  SplitSpace sp;
  cudaError_t e = split_space(ws, nw * P::kPlanes, tiles, splits,
                              (cp + KS - 1) / KS, (long long)P::kM * N, &sp);
  if (e != cudaSuccess) return e;
  conv3x3_tf32_split_kernel<<<(int)std::min<long long>((nw + 255) / 256,
                                                        1024),
                              256, 0, st>>>(static_cast<const float*>(w),
                                            static_cast<float*>(ws), C, cp, O,
                                            3, sp.cnt, sp.ncnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)cp, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {cp * 4ull, cp * 4ull * W, cp * 4ull * W * H};
  const cuuint32_t xb[4] = {(cuuint32_t)KS, (cuuint32_t)cols,
                            (cuuint32_t)(rows + 2), 1};
  e = encode_map<float>(&xmap, x, 4, xd, xs, xb, swizzle_of(P::kS));
  if (e != cudaSuccess) return e;
  const cuuint64_t wd[3] = {(cuuint64_t)cp, (cuuint64_t)O,
                            (cuuint64_t)(9 * P::kPlanes)};
  const cuuint64_t wst[2] = {cp * 4ull, cp * 4ull * O};
  const cuuint32_t wb[3] = {(cuuint32_t)KS, (cuuint32_t)N, 1};
  e = encode_map<float>(&wmap, ws, 3, wd, wst, wb, swizzle_of(P::kS));
  if (e != cudaSuccess) return e;
  const int a_slot = ((rows + 2) * cols * P::kS + 1023) / 1024 * 1024;
  const int stage = P::kABoxes * a_slot + P::kBBytes;
  const int fixed = 1024 + (O + N - 1) / N * N * 4;  // alignment, the bias
  const int stages =
      std::min(kSlicedMaxStages, (kSmemMax - fixed) / (stage + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t bytes = fixed + (size_t)stages * (stage + 16);
  // A split needs two K slices or more: KS = 8 (C <= 8) has one.
  auto kernel = conv3x3_tf32x3_kernel<N, KS, false>;
  if constexpr (KS == 16)
    if (splits > 1) kernel = conv3x3_tf32x3_kernel<N, KS, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kSpecThreads, bytes, st>>>(
      xmap, wmap, static_cast<const float*>(b), static_cast<float*>(y),
      sp.part, sp.cnt, B, H, W, cp, O, lc, stages, a_slot, splits);
  return cudaGetLastError();
}

// Three TF32 passes at N = 64 (O tiles by 64).
cudaError_t tf32x3(const void* x, const void* w, const void* b, void* y,
                   void* ws, int B, int H, int W, int C, int O, int cols,
                   int n, int ks, int grid, int splits, cudaStream_t st) {
  const int lc = cols == 16 ? 4 : cols == 32 ? 5 : cols == 64 ? 6
               : cols == 128 ? 7 : -1;
  if (lc < 0 || grid <= 0 || ws == nullptr || n != 64)
    return cudaErrorInvalidValue;
  if (ks == 8)
    return launch_tf32x3<64, 8>(x, w, b, y, ws, B, H, W, C, O, lc, grid,
                                splits, st);
  if (ks == 16)
    return launch_tf32x3<64, 16>(x, w, b, y, ws, B, H, W, C, O, lc, grid,
                                 splits, st);
  return cudaErrorInvalidValue;
}

// The one-pass kernel: `grid` persistent blocks over units of tiles of 2
// NPX pixels (cols = 1 << lc wide) x 64 MB output channels and `splits` K
// splits a tile, K slices of KS.  x is [B,H,W,Cp] (Cp = C rounded up to
// 4), w the caller's [3,3,C,O]; ws, the wrapper's scratch of 9 O Cp
// floats, takes the rounded weights first, then, where splits > 1, the
// split workspace (split_space).  The ring takes as many stages as fit
// beside the epilogue's staging and the bias, at most kSlicedMaxStages.
template <int MB, int NPX, int KS>
cudaError_t launch_tf32x1(const void* x, const void* w, const void* b,
                          void* y, void* ws, int B, int H, int W, int C,
                          int O, int lc, int grid, int splits,
                          cudaStream_t st) {
  using P = Tf32x1<MB, NPX, KS>;
  const int cols = 1 << lc, rows = P::kM >> lc, cp = (C + 3) / 4 * 4;
  if (rows < 1) return cudaErrorInvalidValue;
  const long long nw = 9LL * cp * O;
  const long long tiles = (long long)((O + P::kBN - 1) / P::kBN)
                          * ((W + cols - 1) / cols) * ((H + rows - 1) / rows)
                          * B;
  SplitSpace sp;
  cudaError_t e = split_space(ws, nw, tiles, splits, (cp + KS - 1) / KS,
                              (long long)P::kM * P::kBN, &sp);
  if (e != cudaSuccess) return e;
  conv3x3_tf32_split_kernel<<<(int)std::min<long long>((nw + 255) / 256,
                                                        1024),
                              256, 0, st>>>(static_cast<const float*>(w),
                                            static_cast<float*>(ws), C, cp, O,
                                            1, sp.cnt, sp.ncnt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap xmap, wmap, ymap = {};
  const cuuint64_t xd[4] = {(cuuint64_t)cp, (cuuint64_t)W, (cuuint64_t)H,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {cp * 4ull, cp * 4ull * W, cp * 4ull * W * H};
  const cuuint32_t xb[4] = {(cuuint32_t)KS, (cuuint32_t)cols,
                            (cuuint32_t)(rows + 2), 1};
  e = encode_map<float>(&xmap, x, 4, xd, xs, xb, swizzle_of(P::kS));
  if (e != cudaSuccess) return e;
  if (O % 4 == 0) {
    const int bc = cols < P::kCPX ? cols : P::kCPX;
    const cuuint64_t yd[4] = {(cuuint64_t)O, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
    const cuuint64_t ys[3] = {O * 4ull, O * 4ull * W, O * 4ull * W * H};
    const cuuint32_t yb[4] = {32, (cuuint32_t)bc, (cuuint32_t)(P::kCPX / bc),
                              1};
    e = encode_map<float>(&ymap, y, 4, yd, ys, yb);
    if (e != cudaSuccess) return e;
  }
  const cuuint64_t wd[3] = {(cuuint64_t)cp, (cuuint64_t)O, 9};
  const cuuint64_t wst[2] = {cp * 4ull, cp * 4ull * O};
  const cuuint32_t wb[3] = {(cuuint32_t)KS, 64, 1};
  e = encode_map<float>(&wmap, ws, 3, wd, wst, wb, swizzle_of(P::kS));
  if (e != cudaSuccess) return e;
  const int a_slot = ((rows + 2) * cols * P::kS + 1023) / 1024 * 1024;
  const int stage = a_slot + P::kABytes;
  // alignment, the epilogue's staging, the bias
  const int fixed = 1024 + 2 * P::kOut + (O + P::kBN - 1) / P::kBN * P::kBN * 4;
  const int stages =
      std::min(kSlicedMaxStages, (kSmemMax - fixed) / (stage + 16));
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t bytes = fixed + (size_t)stages * (stage + 16);
  auto kernel = conv3x3_tf32x1_kernel<MB, NPX, KS, false>;
  if constexpr (KS == 16)  // as launch_tf32x3
    if (splits > 1) kernel = conv3x3_tf32x1_kernel<MB, NPX, KS, true>;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kSpecThreads, bytes, st>>>(
      xmap, wmap, ymap, static_cast<const float*>(b), static_cast<float*>(y),
      sp.part, sp.cnt, B, H, W, cp, O, lc, stages, a_slot, splits);
  return cudaGetLastError();
}

template <int MB, int NPX>
cudaError_t tf32x1_ks(const void* x, const void* w, const void* b, void* y,
                      void* ws, int B, int H, int W, int C, int O, int lc,
                      int ks, int grid, int splits, cudaStream_t st) {
  if (ks == 8)
    return launch_tf32x1<MB, NPX, 8>(x, w, b, y, ws, B, H, W, C, O, lc, grid,
                                     splits, st);
  if (ks == 16)
    return launch_tf32x1<MB, NPX, 16>(x, w, b, y, ws, B, H, W, C, O, lc,
                                      grid, splits, st);
  return cudaErrorInvalidValue;
}

// One pass on the one-pass design: `npx` pixels a warpgroup (128 or 256)
// and `n` = 64 MB output channels a tile (64, or 128 at npx = 128).
cudaError_t tf32x1(const void* x, const void* w, const void* b, void* y,
                   void* ws, int B, int H, int W, int C, int O, int cols,
                   int npx, int n, int ks, int grid, int splits,
                   cudaStream_t st) {
  const int lc = cols == 16 ? 4 : cols == 32 ? 5 : cols == 64 ? 6
               : cols == 128 ? 7 : -1;
  if (lc < 0 || grid <= 0 || ws == nullptr) return cudaErrorInvalidValue;
  if (n == 64 && npx == 256)
    return tf32x1_ks<1, 256>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid,
                             splits, st);
  if (n == 64 && npx == 128)
    return tf32x1_ks<1, 128>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid,
                             splits, st);
  if (n == 128 && npx == 128)
    return tf32x1_ks<2, 128>(x, w, b, y, ws, B, H, W, C, O, lc, ks, grid,
                             splits, st);
  return cudaErrorInvalidValue;
}

// 16-bit dispatch by shape (the header's table).
template <typename T>
cudaError_t conv16(const void* x, const void* w, const void* b, void* y,
                   int B, int H, int W, int C, int O, int R, int cols, int n,
                   int ks, int grid, cudaStream_t st) {
  if (C == kC) return stream<T>(x, w, b, y, B, H, W, O, R, grid, st);
  if (C % 64 == 0 && C >= 128 && O > kSlicedMaxO)
    return wide<T>(x, w, b, y, B, H, W, C, O, cols, n, grid, st);
  if (C <= 7) return narrow<T>(x, w, b, y, B, H, W, C, O, n, grid, st);
  return sliced<T>(x, w, b, y, B, H, W, C, O, cols, n, ks, grid, st);
}

}  // namespace

// x [B,H,W,C], w [3,3,C,O], b [O] or null (all in the storage dtype),
// y [B,H,W,O]; every pointer 16-byte aligned.  The wrapper's plan: `R` and
// `grid` for the streamed kernel (16-bit, C = 64); `cols`, `n` (the tile's
// columns and output channels) and `grid` for the wide kernel (16-bit, C %
// 64 = 0, C >= 128, O > kSlicedMaxO), which takes w as [3,3,C,ld], ld = O
// rounded up to 8; `n` and `grid` for the narrow kernel (16-bit, C <= 7);
// `cols`, `n`, `ks` (the K slice) and `grid` for the sliced kernel (16-bit,
// other C >= 8), which takes w as [3,3,C,ld] and, where C % 8 != 0, x as
// [B,H,W,Cp] and w as [3,3,Cp,ld], Cp = C rounded up to ks; `cols`, `n`,
// `ks` and `grid` for the split-TF32 kernel (fp32, `passes` = 3, `n` =
// 64), which takes x as [B,H,W,Cp] where C % 4 != 0, Cp = C rounded up to
// 4, `splits` (K splits a tile, 1 up to the K slices) and `ws`, a scratch
// of 18 O Cp floats followed, where splits > 1, by the split workspace:
// the fp32 partials of tiles x splits units of 256 pixels x n channels,
// then two int counters a tile (kernels/conv3x3.py
// SlicedPlan.workspace_bytes); with `passes` = 1 the one-pass kernel, with
// `R` its pixels a warpgroup (128 or 256), `n` its output channels a tile
// (64 or 128), `cols`, `ks`, `grid`, `splits` as the split-TF32 kernel's
// (units of 2 R pixels x n channels) and `ws` of 9 O Cp floats before the
// split workspace.  The 16-bit kernels read neither `ws`, `splits` nor
// `passes`.
extern "C" int rr_conv3x3(int dtype, const void* x, const void* w,
                          const void* b, void* y, void* ws, int B, int H,
                          int W, int C, int O, int R, int cols, int n, int ks,
                          int grid, int splits, int passes, void* stream_) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || O <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream_);
  switch (dtype) {
    case RR_F32:
      if (passes == 1)
        return tf32x1(x, w, b, y, ws, B, H, W, C, O, cols, R, n, ks, grid,
                      splits, st);
      if (passes == 3)
        return tf32x3(x, w, b, y, ws, B, H, W, C, O, cols, n, ks, grid,
                      splits, st);
      return cudaErrorInvalidValue;
    case RR_F16:
      return conv16<__half>(x, w, b, y, B, H, W, C, O, R, cols, n, ks, grid,
                            st);
    case RR_BF16:
      return conv16<__nv_bfloat16>(x, w, b, y, B, H, W, C, O, R, cols, n, ks,
                                   grid, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// The same with C = 64 and O <= 64.
extern "C" int rr_conv3x3_c64(int dtype, const void* x, const void* w,
                              const void* b, void* y, void* ws, int B, int H,
                              int W, int O, int R, int cols, int n, int ks,
                              int grid, int splits, int passes,
                              void* stream_) {
  if (O > kC) return cudaErrorInvalidValue;
  return rr_conv3x3(dtype, x, w, b, y, ws, B, H, W, kC, O, R, cols, n, ks,
                    grid, splits, passes, stream_);
}
