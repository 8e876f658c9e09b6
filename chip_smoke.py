"""Smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure exits non-zero before the
result line:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the kernels from the sources in this checkout (one nvcc per CUDA
     source, all started together); read
     the SASS (cuobjdump -sass) and ptxas report of K1's and K1i's kernels
     (csrc/bvh_wide.cuh `wide_kernel`, `inst_wide_kernel`): 16-byte global
     loads required, at most 80 registers, and no local loads or stores,
     stack frame or spills; K5's, K5s's and K8's SASS (the scatter and splat
     entries' adds all RED, the tiled entry without atomics);
     K12's (csrc/bdpt.cu): the tiled `connect_weight_tile_kernel` must load
     from shared memory where it stages (up to 35 vertex slots) and not
     where it reads in place, with no local loads or stores, stack frame or
     spills in any of its four instantiations (staged or in place, with
     media or without); every K12 kernel's registers printed; K7's
     (csrc/layered.cu): the redesigned layered_f, layered_pdf and
     layered_sample kernels with no local loads or stores, stack frame or
     spills, printed beside the yardsticks' (csrc/layered_lane.cu), and the
     samplers' sines and cosines (csrc/bxdf.cuh sin_angle, cos_angle) the
     bits of the library's sinf and cosf on every float below 105615; K6's
     five kernels (csrc/path_step.cu: path_rr, path_shade, path_bsdf,
     path_coat, path_resolve), their VOLUMETRIC variants (path_shade_vol,
     path_bsdf_vol, path_resolve_vol) and the shading yardstick
     path_shade_lane with their registers, stack frame, spills and local
     loads and stores printed, path_shade and path_bsdf required to have no
     stack frame and no spills; K6t's (csrc/transmit.cu transmit_hop_kernel)
     with no local loads or stores, stack frame or spills; K11's (csrc/scene_shard.cu): parts_wide_kernel with 16-byte
     loads and no local loads or stores, stack frame or spills, its
     registers printed; K12m's (csrc/mlt.cu): mutate_kernel and
     accept_splat_kernel with no local loads or stores, stack frame or
     spills, the accept kernel's atomics all RED, their registers printed;
     K3's, K4's and K4a's (csrc/dense_intersect.cu): every instantiation of
     dense_tri_kernel, dense_tri_wide_kernel, dense_sphere_kernel,
     dense_sphere_wide_kernel (closest and any hit) and dense_disk_kernel
     with no local loads or stores, stack frame or spills, their registers
     printed;
  3. the BVH traversal kernel K1 (closest hit and any hit) against its plain
     version on cornell-mesh (levels 5, 16,396 triangles), 65,536 camera rays
     plus 65,536 random interior rays;
  4. the film kernel's two entry points (K5, csrc/film.cu) against their
     plain versions, 131,072 lanes with NaN, zero-pdf and zero-weight lanes
     into a 256^2 film: the scatter entry on random pixel ids within rtol
     1e-5 (the order of its atomic adds), the tiled one on two replicates of
     the pixel grid bit for bit; the splat entry (K5s) likewise, three
     strategies' splats over 43,690 lanes' wavelengths;
  5. the dense kernels (K3 triangles, K4 spheres and disks) against their
     plain versions on 131,072 camera and interior rays of the plain cornell
     box and of caustic-glass, and on synthetic partial spheres and disks
     (z window, phimax < 2 pi, inner radius) with masked lanes; K4's any-hit
     entry the closest-hit entry's idx >= 0 bit for bit (on those rays and
     on shadow rays of random lengths) and the plain version's but on
     clip-edge lanes;
  6. the wavefront recycle kernel (K8, a single-pass scan) against
     torch.cumsum's plain version on random finished masks at the pool size
     and at a size that is not a multiple of its tile, with and without the
     rank, back to back on one scratch, next_work near the end too;
     the layered BxDF kernel (K7: layered_f, layered_sample, layered_pdf)
     against its plain version on 2^18 synthetic lanes (tests/
     layered_cases.py: smooth and rough coats, a medium with g in {-0.5, 0,
     0.7}, smooth and rough conductor bases, wo below the horizon and
     grazing). K7 is not bit-exact (its transcendentals round apart from
     torch's, and the walk compares its draws with them), so it is held
     statistically: valid and flags equal on >= 99.9 % of lanes; f, wi and
     pdf within rtol 1e-4, atol 1e-6 on >= 99.5 %; lane means of f, pdf and
     f |cos| / pdf within 1e-3 relative; the fractions are printed; then
     the three entries against their yardsticks, the kernels as
     first written (csrc/layered_lane.cu): the same bits and step counts
     on those lanes and on as many lanes of a deep medium
     (layered_cases.deep_medium_lanes), all coated, and timed in turns with
     them (yardstick, kernel, kernel, yardstick);
  7. small renders on the card against tests/goldens.npz and against the
     same render on the CPU: cornell-mesh levels 3 at 48^2 x 4 spp, the plain
     cornell box at 64^2 x 8 spp (box filter), caustic-glass with the path
     integrator at 48^2 x 4 spp (card against CPU; its disk light runs the
     disk kernel), and material-testball at 32^2 x 4 spp (box filter, card
     against CPU; the walk seeds on float bits, which differ between the two
     by an ulp, so the renders are independent estimates and are compared on
     16x16-pixel block means and the image mean), rendered again on the card
     with K7's three entries pointed at their yardsticks: the same
     image bits and ray counts; then BDPT: cornell 24^2 x
     8 (box filter) against tests/goldens.npz's cornell_bdpt_24_spp8 and
     the CPU render, caustic-glass (its file's BDPT, max depth 7) at 32^2 x
     4 and cornell-mesh levels 3 at 48^2 x 4 (the BVH route) against the CPU
     render;
  8. the full-width renders through the normal entry point, 256^2, 16 spp,
     max depth 5, mitchell filter: cornell-mesh levels 5 (BVH), the plain
     cornell box (dense), terrain (130,050 PLY triangles, sky and sun: the
     wavefront loop; its compile seconds, and its honest ray count equal to
     the same frame through the batched loop; then both loops' frame times
     in turns, for the wavefront loop's standing against the batched one);
     the cornell-mesh frame's film twice through the batched loop, rgb_sum
     and weight_sum bit-identical (the tiled film add has no atomics); then
     the coated scenes at
     their files' settings, each rendered once (cornell-mesh and staircase
     also keep the arguments of their third K1 and K1a launches, bounce
     rays): staircase (63,212 triangles,
     coateddiffuse; 256^2 x 256 spp stratified, max depth 8; its compile
     seconds, rays/s and peak memory) and material-testball
     (coatedconductor, partial-sphere pedestal; 256^2 x 64 spp, max depth
     6), K7's launches exactly max_depth a wave (layered_pdf twice that)
     and its yardsticks' none; then BDPT at the bench's settings:
     cornell-bdpt (128^2 x 8, max
     depth 5, one wave) and caustic-glass at its file's (256^2 x 64, max
     depth 7, four waves of 2^20 lanes). Each is driven with the launch
     counts set to 0 just before it and read just after; every kernel of its
     path must have launched (a BDPT frame: exactly K12's two entry points,
     one K5, one K5s and one occluded dispatch a wave (K3a, K4's any-hit
     entry, K4a), and 2 max_depth + 1 closest-hit dispatches; the cornell
     and testball frames K4's two entries (their counts printed); neither
     K12's yardstick entries nor the packed
     copy they read, bdpt.pack_vertices / pack_endpoints). The batched and
     BDPT frames launch K5's tiled entry, the wavefront frame its scatter
     entry and K8; every frame of the path family on the card (the "cuda"
     route of path.step_route: every path-integrator render) launches
     path_rr, path_shade, path_bsdf and path_resolve max_depth times a wave
     on the
     batched loop (cornell-mesh, cornell, staircase, testball, the
     scene-sharded and instanced frames), once an iteration on the
     wavefront loop (terrain) and max_depth times an evaluation of an
     mltpath frame (its bootstrap's, its initial states' and its passes'),
     path_coat as often in the frames with coated materials (staircase,
     testball) and in no other, and BDPT and MLT over BDPT none of K6; no
     render launches a yardstick (path_shade_lane, layered_*_lane);
  9. K1 and K1a on five launches each (the first of cornell-mesh, terrain
     and staircase, the third of cornell-mesh and staircase): against the
     plain version with phase 3's criteria, the operation bound from
     bvh.traversal_work's oracle count (the same work whatever traverses),
     and graph-timed twice; then
     each other kernel against its plain version again, and timed beside its
     plain version, its bound and (film: index_add_ of the lanes' rgb, and of
     their (w rgb, w) rows, which is K5's whole scatter; the tiled entry
     also the sum over its k replicates; recycle: torch.cumsum) one PyTorch
     call: the kernel and the library call from CUDA-graph
     replays (device time, without the host's time to launch each call,
     which the log prints beside it), the plain version with CUDA events;
     all on the arguments of its first
     launch in the full-width render of its path: the shapes and data the
     main path gives it; K3 and K3a at cornell's and caustic-glass BDPT's
     first launches, K4 (closest hit and any hit) at cornell's, testball's
     and caustic-glass BDPT's first launches (its first walk launch and its
     first occluded dispatch) and over that wave's 15 walk launches summed,
     and K4a at caustic-glass's path and BDPT frames' first
     launches, each timed at the launch shape its wrapper picks, beside an
     empty launch in a graph, with every other launch shape the wrapper
     can pick (K3's group size G and mode; K3a's, K4's and K4a's mode)
     bit-equal to the wrapper's; K7's
     three entry points on their first launches in the staircase and
     testball frames, against the plain version on the coated lanes and
     against their yardsticks' bits, timed on both (the share of coated
     lanes whose sample reflects at the coat printed), the kernels line
     taking staircase's, each bound from the bytes its lanes' BxDF kinds
     need, then layered_sample over staircase's first wave (each launch
     the yardstick's bits), times the frame's waves; K12 on the first waves of the two BDPT frames, on a
     24^2 x 2 wave of tests/bdpt_cases.py's four-light scene (distant, spot,
     uniform infinite and three kinds of area light) and on 24^2 x 2 cornell
     waves at max depth 8 (one staged buffer) and 17 (vertices read in
     place) against its plain
     version (bdpt_cases: every strategy within rtol 1e-4, atol 1e-6 on >=
     99.99 % of its live lanes, equal ray counts) and both entry points
     against their yardsticks, K12 as first written (one thread per lane
     over the packed copy: bdpt_cases.compare_yardstick, the same bits), both
     timed on caustic-glass's, and the caustic-glass frame's and one wave's
     connections' peak device memory; K5s
     on caustic-glass's and cornell-bdpt's first launches (live splats and
     the most on one pixel printed); K8 on
     terrain's first launch with and without the rank, and under
     torch.profiler one device kernel a call; the refit of K1's winners
     (bvh_refit, csrc/bvh_traverse.cu: the hit record's glue in one
     launch) bit-exact with its plain version on cornell-mesh's first
     closest-hit launch and timed; K6 (path_rr, path_shade and path_bsdf
     together and each alone, path_resolve) against its plain parts with
     tests/path_cases.py's
     criteria (draws and masks bit-exact on >= 99.9 % of lanes; float
     fields within rtol 1e-4, atol 1e-6 on >= 99.5 %; lane means within
     1e-3; the fractions printed) on path_cases' synthetic lanes of the
     four-light scene (both samplers, 2^18 and 1,000 lanes) and on the first
     and third bounces of the cornell-mesh, cornell and terrain frames,
     path_shade and path_bsdf against their yardstick path_shade_lane's bits
     on every lane of each of those bounces (and of staircase's and
     testball's), each kernel timed on cornell-mesh's first bounce beside
     its bound and its plain part, path_shade and path_bsdf together at
     cornell-mesh's and staircase's first bounces beside the function's
     bound and over staircase's first wave
     (every bounce) times its waves, the device kernels of that bounce on
     either route under
     torch.profiler (the CUDA step's at most a twentieth of the plain
     step's), and the frames of cornell-mesh, cornell and terrain (both
     loops) with the step pointed at its plain version by this script, in
     turns plain, cuda, cuda, plain: ray counts within 0.1 %, images within
     check_image, walls, rays/s, busy share (a profiled frame's device time
     over the median wall) and device kernels a frame of either route, and
     the terrain loops' ratio (the K8 condition); the coated lanes and the
     MLT kind: the five kernels (path_coat around K7's launches from the
     step) against the plain parts on path_cases' coated scene and with the
     MLT kind over vectors of 6 and 30 dimensions (2^18 and 1,000 lanes) and
     on the first and third bounces of the staircase and testball frames,
     path_coat against coat_plain on identical inputs (floats within rtol
     1e-4, atol 1e-6 on >= 99.5 % of lanes), the whole coated bounce (draws
     bit-exact, the coated lanes' L, beta and prev_pdf on their lane means,
     path_cases.Report.coat_mean, the share of lanes bit-exact printed),
     the five kernels timed on staircase's first bounce beside their bounds
     and plain parts, the device kernels of a staircase bounce on either
     route, and the testball (plain, cuda, cuda, plain) and staircase
     (plain, cuda, cuda) frames: ray counts within 1 %, 8x8 block means
     within check_image (R7), walls, rays/s, busy share and device kernels
     a frame (the CUDA frames) and each frame's peak memory over what was
     held before it (chiprun_out/k6_frames.json);
 10. MLT: cornell 24^2 with mltpath and mltbdpt (1024 chains, 18 passes)
     on the card and on the CPU with one seed (tests/mlt_cases.py: >= 99 %
     of the (chain, pass) accept decisions equal, 8x8 block means within
     5 %); caustic-glass with mlt (MLT over BDPT, max depth 7) and
     cornell-mesh levels 5 with mltpath (max depth 5) at 256^2 with 8192
     chains through render(), cut from 100 to 4 and 8 mutations per pixel
     (32 and 64 passes) so that the phase fits this script's time, each
     with K12m-a and K12m-b launched exactly once a pass and its image mean
     within mlt_cases.FRAME_MEAN_RTOL of phase 8's BDPT or path frame (the
     mltpath renders' evaluations on the CUDA path step with the MLT kind,
     K6 max_depth times an evaluation; the cornell-mesh frame's median pass
     time at 8 passes beside the plain step's, in turns); both
     kernels against their plain versions on those frames' first passes
     (draws and chain state bit-exact, splat sums within 1e-5) and timed on
     both (caustic-glass: D 160, C 8; cornell-mesh: D 66, C 1) beside their
     byte bounds, plain versions and (K12m-b) index_add_; K3, K3a, K4a and
     K4 (closest and any hit) at the caustic-glass-mlt frame's first
     8,192-lane evaluation and its occluded dispatch as at phase 9's
     launches; K12 on the caustic-glass-mlt frame's first 8192-lane
     evaluation as on phase 9's waves (plain, yardstick bits, both entry
     points timed), and no yardstick or packed copy in either MLT frame.
     The yardsticks (path_shade_lane, layered_*_lane, K12's *_lane) are
     held to their bits in phases 6b, 9 and 10 and no longer timed (PERF.md
     records them in turns); those phases' seconds are printed beside
     YARDSTICK_PHASES_S, what they took when they still timed them;
 11. scene sharding (K11a `bvh_closest_hit_parts`, K11b `bvh_any_hit_parts`,
     `shard_select`, csrc/scene_shard.cu): (a) cornell-mesh levels 5 split
     into 8 morton parts (per-part tables under a quarter of the unsharded
     ones); on phase 3's 131,072 camera and interior rays K11a's candidate
     packs and K11b's bits bit-exact with their plain versions and with the
     unfused yardstick (K1 over each part, then an argmin); against the unsharded K1 equal hit sets, t
     within rtol 1e-5, the same triangle on >= 99 % of hits and equal t on
     the rest; the select kernel bit-exact with its plain version on 4
     stacked packs with planted ties; (b) the scene-sharded frames through
     render() of the scene split by render.shard_scene (its host build timed
     alone): cornell-mesh (8 parts) and terrain (4 parts, the batched loop)
     at phase 8's settings, K11a and K11b launched and K1 not, the ray counts equal to phase 8's frames (terrain: the
     batched loop's), the images within check_image of them; then the walls
     in turns of cornell-mesh and its 8 parts, terrain's batched loop and its
     4 parts; (c) NCCL at world size 1 (a file store): the pixel-parallel
     cornell-mesh frame (its film all-reduced) and the scene-sharded one
     through render(shard_parts=8), as the CLI's --shard-scene calls it
     (every closest hit through an all_gather and the select kernel, every
     shadow batch through an all_reduce), each with phase 8's ray count and
     image; (d) K11a and K11b at their first launches in (b)'s cornell-mesh
     and terrain frames (2^20 lanes): held against their plain versions and
     the unfused yardstick again (K11a bit-exact but for verified ties, K1's criterion
     of phases 3 and 9: a winner that differs must hit at a t within 1e-6
     relative of the other's; over 2^20 lanes a tie decided by the traversal
     order or a box's entry distance occurs), timed in turns with the
     unfused yardstick and K1/K1a over the unsharded table on
     the same rays, beside the bound from the oracle count of
     ss.parts_work (the same work whatever traverses) and the kernels' own
     work sums, the targets (K11a <= 0.90 ms, K11b <= 1.10 ms, K11a's rows
     <= 1.5x K1's, the sharded cornell-mesh wall <= 1.3x) printed met or
     missed; and the select kernel at its first launch in (c), timed beside
     its plain version and byte bound. Scaling across cards is not
     measurable on one card;
 12. instancing (K1i `bvh_closest_hit_inst`, `bvh_any_hit_inst`: K1's wide
     loop over a two-level table, csrc/bvh_wide.cuh `inst_wide_kernel`),
     on the instanced cornell box of testscenes.instanced_cornell_pbrt (36
     ball and 16 gem instances): (a) at levels (3, 2), every instance shared, on 131,072
     camera and 131,072 interior rays: closest hit bit-exact with the plain
     version (t, prim and inst) but on verified ties (K1's criterion), any
     hit equal; against K1 on the same scene flattened: hit masks equal on
     >= 99.99 % of lanes and, on every common hit, t within rtol 1e-4 plus
     1e-5 of the ray origin's magnitude plus the grazing term derived at
     the check (the twins' rounding over |cos| of the incidence angle), or,
     where the winners differ, the nearer winner's twin rejected in the
     other geometry by the watertight test's t error bound alone (the
     fractions within rtol 1e-4 and within that plus 1e-5 |o| are printed);
     (b) the scene at 48^2
     x 4 (path) on the card against the CPU and against the card's
     flattened render, at 24^2 x 8 through BDPT (K12, K5s and K1i launched)
     against the CPU, and 1024 chains of mltpath at 24^2 on the card and the
     CPU with one seed (tests/mlt_cases.py's criteria); (c) the full-width
     frame cornell-instanced at levels INST_LEVELS (5, 5) under instancing
     "auto" (425,996 world triangles: 253,964 flattened, 21 instances of 2
     prototypes of 16,384 triangles; cut from (6, 5), 1,310,732 world
     triangles, whose flattened twin's host build took ~85 s) at 256^2 x 16,
     max depth 5, mitchell,
     through render(): K1i launched and K1 not, its compile seconds, peak
     memory and table bytes; then the same file flattened (K1), then the
     two frames in turns (instanced, twin, twin, instanced, FRAME_ROUNDS
     times): honest rays/s (median and quartiles), frame seconds (median)
     and the ratio of each round's two instanced frames to its two twins
     (median and quartiles; the target <= 1.3x printed met when the upper
     quartile meets it, missed when the lower one misses it, and else not
     established); the twin's ray
     count within 1 % and its image against the instanced one: means within
     1 % and check_image's per-pixel tolerance on >= 98 % of pixel values
     (the twins round their geometry apart, and a path that an ulp turns at
     a glass or glossy surface moves its pixel at 16 spp), while the noise
     floor, the flattened frame against its own second estimate (samples
     16..31), must fall outside that 2 %; where the bad pixels lie (gems,
     balls) is printed with the same numbers; (d) K1i at its first launches
     in (c)'s frame (2^20 lanes): held against its plain version on those
     arguments (closest hit bit-exact but on verified ties, any hit equal),
     and graph-timed in turns with the flattened frame's K1 on the same
     rays (a yardstick, not a library call), beside the bound from
     bvh.traversal_work's two-level oracle count, the plain version, the
     rows each kernel reads (their own stats) and the time recorded for the
     loop K1i ran on before its redesign at levels (6, 5) (K1I_OLD_LOOP_MS),
     the targets set at levels (6, 5) (K1i <= 0.55 ms, K1i-a <= 0.40 ms,
     each <= 1.3x the twin's) printed met or missed; the refit of the frame's first closest hits (instanced
     winners' object rays formed in the kernel) bit-exact with its plain
     version;
 13. participating media on volumetric-caustic (homogeneous fog as the
     camera's and the spot light's medium, a glass ball in the beam):
     16^2, max depth 3, with the path integrator and BDPT on the card
     against the CPU (4x4 block means within check_image, ray counts within
     0.1 %); then through render() BDPT at the bench's 128^2 x 8, the path
     integrator at its file's 128^2 x 16 and its file's MLT over BDPT (128^2,
     max depth 7, 376 primary samples a chain) cut from 100 to 8 mutations
     per pixel (16 passes), each with the launch counts set to 0 just
     before it and read just after: the path frame path_rr and the
     VOLUMETRIC kernels path_shade_vol, path_bsdf_vol and path_resolve_vol
     2 max_depth + 4 times a wave and K6t (transmit_hop, csrc/transmit.cu)
     8 times that, none of the other K6 kernels; BDPT K6t 8 times a wave;
     MLT 8 times an evaluation (frame walls, ray counts, peak memory
     printed); K6t bit-exact with transmit_hop_plain at the path and BDPT
     frames' first launches; the VOLUMETRIC kernels against the plain parts
     at the path frame's first and third bounces (draws, masks, medium and
     depth bit-exact, floats to tests/path_cases.py's criteria); K12's MEDIA
     instantiations on the BDPT frame's wave (the segments bit-exact with
     connect_segments_plain, the stage with the transmittance loop to
     tests/bdpt_cases.py's criterion); each graph-timed beside its bound
     and plain version;
 14. textures, mix and named materials: K13 (csrc/texture.cu tex_eval)
     against its plain version (textures.eval_lanes_plain) on
     tests/texture_cases.py's synthetic lanes (every node type, mapping,
     wrap mode, image format and textured slot, a mix material) with and
     without footprints, materials and slot masks bit-exact and the values
     to texture_cases' criterion; then through render() the textured
     cornell-mesh's (testscenes.textured_cornell_mesh_pbrt, levels 5) path
     frame (256^2 x 16, depth 5), its BDPT frame (128^2 x 8) and its mltpath
     frame cut to 1 mutation per pixel (8 passes), K13 once a bounce on the
     path and mltpath frames and once a walk step on the BDPT frame (every
     earlier frame, untextured, is required to launch none), BDPT's and
     mltpath's means within 10 % of the path frame's; rows 192-207 of the
     path frame against the same rows' lanes rendered on the CPU (the same
     random numbers) to tests/test_parity.py's criterion on 4x4 block
     means (the mix hashes float bits that the kernels and the plain step
     round apart, so some paths go on independently), rays within 1 %; the
     means of card
     frames at 32^2 x 16, 32^2 x 1024 and 256^2 x 16 under a box filter
     logged beside the path frame's; K13 and path_shade / path_bsdf on the
     path frame's first bounce against their plain versions, K13
     graph-timed beside its bound (texture_cases.tex_work) and plain
     version; each of K13's walk launches of the BDPT frame's wave against
     its plain version, timed and summed;
 15. a `kernels` JSON line; the last line is the JSON result.
Without a card, or outside a checkout of the repository, it fails.
"""
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# float32 outside the tensor cores: the published 67 TFLOP/s counts a fused
# multiply-add as two ops; the kernels count every mul and add on its own
# (the CUDA sources are built with --fmad=false), and those run at one op
# a lane a cycle: 132 SMs x 128 lanes x 1.98 GHz, half the published rate
H100_F32_OPS_PER_S = 67e12 / 2
# float ops counted from the CUDA sources: one internal-row visit (8 slab
# tests); a triangle test by how far it goes (watertight.cuh): every test
# to the edge-sign exit, those past it to the det / t-range exit, those past
# that to the t error bound, and the barycentrics of a refit winner; one
# sphere and one disk candidate of dense_intersect.cu, and the reprojection
# of a sphere hit
SLAB_VISIT_OPS = 8 * 22
TRI_EDGE_OPS, TRI_RANGE_OPS, TRI_BOUND_OPS, TRI_BARY_OPS = 30, 11, 33, 3
TRI_FULL_OPS = TRI_EDGE_OPS + TRI_RANGE_OPS + TRI_BOUND_OPS
SPHERE_TEST_OPS = 35
SPHERE_HIT_OPS = 30
DISK_TEST_OPS = 36
# float ops of one film lane, counted from csrc/film.cu (its splat entry does
# the same per splat whose L row is not all zero)
FILM_LANE_OPS = 4 * 10 + 3 * 2 + 4
# float ops of K12 per lane and strategy, counted from csrc/bdpt.cu and
# csrc/bxdf.cuh and rounded down: bdpt_connect_rays forms a strategy's
# connection (one or two directions and BSDF values in local frames, the
# geometry term, the offset shadow ray: ~100); bdpt_connect_weight forms it
# again and the MIS weight (four junction pdfs, each a direction, a BSDF,
# camera or light pdf and an area conversion, ~60, and the ratio walks)
K12_OPS = {"bdpt_connect_rays": 100, "bdpt_connect_weight": 400}
# float ops of K7, counted from csrc/layered.cu and csrc/bxdf.cuh for the
# main path's lanes (a rough dielectric coat over a diffuse or rough
# conductor base, no medium), rounded down: a rough dielectric sample ~150,
# its f or pdf ~100; a diffuse sample ~20, its pdf ~10; a conductor sample
# ~400 (four complex Fresnel terms). (per lane, per step): layered_f per
# lane f_enter and two samples, per walk step a boundary event (an exit
# resample, or NEE through the base plus a base resample and the coat's f
# and pdf); layered_sample per lane the coat's sample, per step one
# interface sample; layered_pdf per lane with wo and wi on one side the
# coat's pdf and two samples, per lane that reaches the base its pdf
LAYERED_OPS = {"layered_f": (400, 250), "layered_sample": (150, 100),
               "layered_pdf": (400, 10)}
# float ops of one instance entry of K1i, counted from csrc/bvh_wide.cuh
# `enter_instance` and csrc/watertight.cuh: two 3x4 transforms (a dot
# product is a multiply and two fused multiply-adds, 5 ops; the origin adds
# its translation: 18 + 15), the shear (10) and 1/d (12)
INST_ENTRY_OPS = 55
# ms of the loop K1i ran on before its redesign (one thread a ray, a
# local-memory stack of (row, child-mask) entries that revisit rows), at
# the first closest-hit and any-hit launches (2^20 lanes) of the
# cornell-instanced frame, graph-timed in turns with the redesigned kernel
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6); the loop is no
# longer built
K1I_OLD_LOOP_MS = {"bvh_closest_hit_inst": 1.0008, "bvh_any_hit_inst": 0.7279}
# rounds of phase 12's instanced frame and its flattened twin in turns
FRAME_ROUNDS = 10
# phase 12's instanced frame: levels of its balls and gems, cut from (6, 5)
# (1,310,732 world triangles, 42 instances; the twin's host build ~85 s) to
# keep the script within half its time limit; profile_render renders (6, 5)
INST_LEVELS = (5, 5)
# float ops of K6, counted from csrc/path_step.cu and csrc/bxdf.cuh and
# rounded: path_rr per lane due for RR (the uniform, the max, four
# divisions); path_shade per shading lane (the material's spectra and frame
# ~80, the light pick and sample ~60, a triangle's spherical sample ~250,
# the BSDF's f and pdf and its sample from ~100 (diffuse) to ~800 (a rough
# conductor's complex Fresnel terms), the MIS weight and the new ray): ~600,
# per emitter hit its MIS pdf (a triangle's inverted spherical sample) ~300,
# per escaped lane ~15, per coated lane its layer instead of the BSDF (three
# sigmoid spectra and the conductor's k, ~150); path_coat per coated lane
# (the frame ~25, the world direction and back ~30, the new beta and origin
# ~30, the NEE term and its weight ~35) ~120; path_resolve per NEE lane 8.
# Of a shading lane's ~600, path_bsdf's (the BSDF sample, the new beta and
# ray, the draws past NEE's) ~200, path_shade's the rest
# float ops of the media kernels, counted from csrc/path_step.cu and
# csrc/transmit.cu and rounded: the distance event of a lane in a medium (two
# sigma rows at four wavelengths, log1p, a division, four exps or the sigma_s
# / sigma_t scale: ~120); path_resolve_vol per NEE lane (the transmittance's
# mean, the weight, the term: ~40); K6t per live lane (four exps and the
# attenuation, the offset origin: ~110) and per lane (the next t_max: ~10)
# seconds of phases 6b, 9 and 10 when they still timed the yardsticks in turns
# with their kernels, by this script on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md records the run)
YARDSTICK_PHASES_S = 406.4
VOL_OPS = {"event": 120, "resolve": 40, "hop": 110, "hop_lane": 10}
K6_OPS = {"rr": 12, "shade": 600, "emit": 300, "escape": 15, "layer": 150, "coat": 120,
          "resolve": 8, "shade_bsdf": 200}
# float ops of K12m-a per chain and dimension, counted from csrc/mlt.cu:
# two uniforms (a multiply and a min each), erfinv (~15 with its log and
# two square roots), the perturbation, the wrap and the clip (~8)
MUTATE_OPS = 25


def log(msg):
    print(msg, flush=True)


def events_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, calls=20, reps=5):
    """Device milliseconds of one fn() call: `calls` calls captured in one
    CUDA graph, replayed `reps` times between CUDA events, so the host's
    time to launch each call (argument checks, output allocations, the
    launch) is not counted. fn launches on the current stream and does not
    synchronize."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (reps * calls)


def profile_windows(windows):
    """Run each (name, fn) of `windows` in one torch.profiler session, each
    between synchronizations and 50 ms after the last, and sort the device
    events by the window they ran in (the session's timeline is the host's
    clock). -> {name: (device kernels, other device events (memsets and
    copies), their device milliseconds, the kernels' names)}. This process
    may profile only once: a second session, after CUDA graph replays,
    recorded no device kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for name, fn in windows:
            time.sleep(0.05)
            with torch.profiler.record_function(f"window {name}"):
                fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    spans = {e.name[len("window "):]: (e.time_range.start, e.time_range.end) for e in events
             if e.name.startswith("window ") and e.device_type != cuda}
    device = [e for e in events if e.device_type == cuda and not e.name.startswith("window ")]
    out = {}
    for name, (a, b) in spans.items():
        inside = [e for e in device if a <= e.time_range.start <= b + 1000]
        kern = [e for e in inside if not e.name.startswith(("Memset", "Memcpy"))]
        out[name] = (len(kern), len(inside) - len(kern),
                     sum(e.time_range.end - e.time_range.start for e in inside) / 1e3,
                     [e.name for e in kern])
    return out


def kernel_ms(fn, reps=50):
    """(device ms of one call from graph_ms, ms of one call launched by
    the host back to back, from events_ms)."""
    return graph_ms(fn), events_ms(fn, reps)


def sass_memory_ops(sass):
    """{kernel symbol: {opcode: count}} of the memory (global, local,
    shared and generic), atomic and shuffle instructions in `cuobjdump
    -sass` output."""
    import collections
    import re

    out, func = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            func = m.group(1)
            out[func] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", line)
        if m and func and m.group(1).startswith(("LDG", "STG", "LDL", "STL", "ATOM", "RED",
                                                  "LDS", "STS", "SHFL", "LD.", "ST.")):
            out[func][m.group(1)] += 1
    return out


def interface_bytes(kind):
    """(R,) bytes of an interface that its kind needs: kind, ax and ay
    (12), and a dielectric's eta (4), a conductor's complex IOR (32), a
    diffuse reflector's reflectance (16), a diffuse transmitter's
    reflectance and transmittance (32) (csrc/layered.cu load_needed)."""
    extra = torch.tensor([16, 32, 4, 32], dtype=torch.int64, device=kind.device)
    return 12 + extra[kind.long().clamp(0, 3)]


def reached(name, p, args, mask):
    """The lanes of `mask` that read past the coat, counted by the
    entry's step counter at max_depth 1: layered_f's walks that start,
    layered_sample's that enter the layer, layered_pdf's estimates that
    reach the base."""
    from pbrt_tpu_torch.materials import layered

    st = torch.zeros(1, dtype=torch.int64, device=mask.device)
    getattr(layered, f"{name}_cuda")(p._replace(max_depth=1), *args, mask, st)
    return int(st.item())


def k7_bytes(name, p, args, mask):
    """(bytes, note): what K7's entry must move on these lanes: each
    input read once, by the lanes that need it, each output written once,
    every lane, and every lane reads the mask. A coated lane reads its
    directions (wo, wi or wo, uc, u2: 24) and the coat's fields by kind
    (layered_pdf: only with wo and wi on one side; on the others its pdf
    is a constant). The base is read by kind where it is needed:
    layered_f on the lanes whose exit is the base (wo and wi on opposite
    sides) and on those whose walk starts, layered_sample on those that
    enter the layer, layered_pdf where its estimate reaches the base;
    thickness, g and albedo (24) by layered_f's and layered_sample's
    walking lanes."""
    R_ = mask.shape[0]
    out_b = {"layered_f": 16, "layered_sample": 41, "layered_pdf": 4}[name]
    top_b, bot_b = interface_bytes(p.top.kind), interface_bytes(p.bottom.kind)
    same = (args[0][:, 2] * args[1][:, 2] > 0) if name != "layered_sample" else None
    coat_lanes = mask & same if name == "layered_pdf" else mask
    n_bytes = R_ * (1 + out_b) + int(mask.sum()) * 24 + int(top_b[coat_lanes].sum())
    base_fixed = (mask & ~same) if name == "layered_f" else torch.zeros_like(mask)
    n_bytes += int(bot_b[base_fixed].sum())
    # the rest of the base reads, by base kind: the lanes past the coat
    # among those not counted yet
    rest = mask & ~base_fixed
    if name == "layered_pdf":
        rest = rest & same
    for k in torch.unique(p.bottom.kind[rest]).tolist():
        sel = rest & (p.bottom.kind == k)
        n_bytes += reached(name, p, args, sel) * int(interface_bytes(
            torch.tensor([k], device=mask.device)))
    n_walk = reached(name, p, args, mask) if name != "layered_pdf" else 0
    n_bytes += n_walk * 24
    return n_bytes, (f"{int(base_fixed.sum())} exit through the base, {n_walk} walk"
                     if name != "layered_pdf" else
                     f"{int(coat_lanes.sum())} with wo, wi on one side")


def require(ok, *what):
    """A phase check: raise (and so exit non-zero) when it does not hold."""
    if not ok:
        raise RuntimeError("chip_smoke check failed: " + " ".join(map(str, what)))


def check_image(img, golden, name, atol=5e-3, rtol=0.05):
    """The image criterion of tests/test_parity.py::_check."""
    require(np.isfinite(img).all(), name)
    err = np.abs(img - golden)
    tol = atol + rtol * np.abs(golden)
    frac_bad = float((err > tol).mean())
    require(frac_bad < 0.005, name, frac_bad, float(err.max()))
    require(abs(img.mean() - golden.mean()) < 0.01 * max(golden.mean(), 1e-3),
            name, float(img.mean()), float(golden.mean()))
    return frac_bad


def bound(nbytes, ops):
    """(least ms, "bytes" or "operations") of the H100 for the work."""
    tb, to = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_OPS_PER_S * 1e3
    return (max(tb, to), "bytes" if tb >= to else "operations")


def tri_test_ops(n_tests, n_edge, n_range):
    """Float ops of n_tests watertight tests of which n_edge got past the
    edge-sign test and n_range past the t-range test."""
    return n_tests * TRI_EDGE_OPS + n_edge * TRI_RANGE_OPS + n_range * TRI_BOUND_OPS


def tri_stages(o, d, t_max, p0, p1, p2):
    """(R, T) masks of how far the watertight test of every ray against
    every triangle goes at a fixed t_max (csrc/watertight.cuh, the plain
    arithmetic of geometry/intersect.py): past the edge-sign test, and past
    the det and t-range tests."""
    from pbrt_tpu_torch.accel import bvh

    return bvh.watertight_stages(o[:, None], d[:, None], t_max[:, None], p0[None], p1[None],
                                 p2[None])


def dense_empty_ms():
    """Device ms of an empty launch in a graph: a one-element torch add,
    graph-timed as the kernels are (the floor under a small wave)."""
    one = torch.zeros(1, device="cuda")
    return graph_ms(lambda: one.add_(0.0))


def dense_modes(kind, args):
    """{label: fn} launching the dense kernel `kind` ("tris", "any",
    "spheres", "spheres_any" or "disks") through its C entry on `args` (the
    wrapper's arguments) in each mode and launch shape its wrapper can
    pick: K3 in its wide-wave mode (G 1) and its small-wave mode at G 1, 2,
    4, 8; K3a, K4 (closest and any hit) and K4a in either mode. Each fn
    writes its own outputs, kept as fn.out."""
    from pbrt_tpu_torch.geometry import intersect as ix

    o, d, t_ = args[:3]
    R, dev = o.shape[0], o.device
    stream = lambda: ix._stream(dev)
    lib = ix._dense_lib()
    fns = {}

    def entry(label, call, out):
        def fn():
            require(call(*(x.data_ptr() for x in out)) == 0, label, "launch failed")
        fn.out = out
        fns[label] = fn

    ray = [o.data_ptr(), d.data_ptr(), t_.data_ptr()]
    if kind in ("tris", "any"):
        p0, p1, p2 = args[3:6]
        T, any_hit = p0.shape[0], int(kind == "any")
        ptrs = [x.data_ptr() for x in (p0, p1, p2)]
        for g, wide in ((1, 1), (1, 0)) + (() if any_hit else ((2, 0), (4, 0), (8, 0))):
            entry(f"G{g} {'wide' if wide else 'small'}",
                  lambda t, p, b, g=g, wide=wide: lib.pbrt_dense_tris(
                      *ptrs, T, *ray, R, t, p, b, any_hit, g, ix.dense_tri_stride(T), wide,
                      stream()),
                  (torch.empty(R, device=dev),
                   torch.empty(R, dtype=torch.bool if any_hit else torch.int64, device=dev),
                   torch.empty((R, 3), device=dev)))
    elif kind in ("spheres", "spheres_any"):
        soa = args[3]
        n, tab, partial = soa.center.shape[0], soa.table.data_ptr(), int(soa.rot is not None)
        any_hit = int(kind == "spheres_any")
        for wide in (0, 1):
            entry("wide" if wide else "small",
                  lambda t, i, p, nn, wide=wide: lib.pbrt_dense_spheres(
                      tab, n, *ray, R, t, i, p, nn, partial, wide, any_hit, stream()),
                  (torch.empty(R, device=dev),
                   torch.empty(R, dtype=torch.bool if any_hit else torch.int64, device=dev),
                   torch.empty((R, 3), device=dev), torch.empty((R, 3), device=dev)))
    else:
        soa = args[3]
        n, tab, partial = soa.center.shape[0], soa.table.data_ptr(), int(soa.xaxis is not None)
        for wide in (0, 1):
            entry("wide" if wide else "small",
                  lambda t, i, p, nn, wide=wide: lib.pbrt_dense_disks(
                      tab, n, *ray, R, t, i, p, nn, partial, wide, stream()),
                  (torch.empty(R, device=dev), torch.empty(R, dtype=torch.int64, device=dev),
                   torch.empty((R, 3), device=dev), torch.empty((R, 3), device=dev)))
    return fns


def dense_bound(kind, args):
    """(least ms, "bytes" or "operations", hits, note) of the dense sweep on
    these rays. K3: each live lane's tests by exit stage against its fixed
    t_max (the any-hit sweep up to its first hit) and the winner's
    barycentrics; every lane's t_max read, a live lane's (t_max > 0) o and
    d (24 bytes: a masked lane needs no ray), the table once, 24 bytes out
    a lane (t, an int64 prim, b; any hit: a bool). K4a: live lanes x disks
    x DISK_TEST_OPS, the same reads, 36 bytes out (t, an int64 index, p,
    n). K4: live lanes x spheres x SPHERE_TEST_OPS and a hit's
    SPHERE_HIT_OPS, the same reads (64-byte rows), 36 bytes out; its any-hit
    entry a live lane's spheres up to its first passing root and 1 byte
    out."""
    from pbrt_tpu_torch.geometry import intersect as ix

    o, d, t_ = args[:3]
    R = o.shape[0]
    n_live = int((t_ > 0).sum())
    ray_b = R * 4 + n_live * 24
    if kind in ("spheres", "spheres_any"):
        soa = args[3]
        n_q = soa.center.shape[0]
        _, ok = ix._sphere_candidates(o, d, t_, soa)
        ok = ok & (t_ > 0)[:, None]
        hit = ok.any(1)
        n_h = int(hit.sum())
        if kind == "spheres":
            b = bound(ray_b + n_q * 64 + R * 36,
                      n_live * n_q * SPHERE_TEST_OPS + n_h * SPHERE_HIT_OPS)
            return b[0], b[1], n_h, f"{n_h} hits"
        first_hit = torch.where(hit, ok.int().argmax(1) + 1, n_q)
        n_t = int(first_hit[t_ > 0].sum())
        b = bound(ray_b + n_q * 64 + R, n_t * SPHERE_TEST_OPS)
        return b[0], b[1], n_h, f"{n_h} occluded, {n_t} tests"
    if kind == "disks":
        soa = args[3]
        n_q = soa.center.shape[0]
        n_h = int((ix.intersect_disks_dense_plain(o, d, t_, soa)[1] >= 0).sum())
        b = bound(ray_b + n_q * 60 + R * 36, int((t_ > 0).sum()) * n_q * DISK_TEST_OPS)
        return b[0], b[1], n_h, f"{n_h} hits"
    tris = args[3:6]
    T = tris[0].shape[0]
    edge, in_range = tri_stages(o, d, t_, *tris)
    tested = (t_ > 0)[:, None].expand(R, T)
    if kind == "any":
        _, hit = ix.intersect_tri_block(o, ix.ray_shear(d), t_, *tris)
        first_hit = torch.where(hit.any(1), hit.int().argmax(1), T)
        tested = tested & (torch.arange(T, device=o.device)[None] <= first_hit[:, None])
        n_h, out_b = int(hit.any(1).sum()), R
    else:
        n_h, out_b = int((ix.intersect_tris_dense_plain(o, d, t_, *tris).prim >= 0).sum()), R * 24
    n_t, n_e, n_r = (int(x.sum()) for x in (tested, tested & edge, tested & in_range))
    ops = tri_test_ops(n_t, n_e, n_r) + (0 if kind == "any" else n_h * TRI_BARY_OPS)
    b = bound(ray_b + T * 36 + out_b, ops)
    return b[0], b[1], n_h, (f"{n_h} {'occluded' if kind == 'any' else 'hits'}, {n_t} tests, "
                             f"{n_e} past the edge test, {n_r} past t range")


DENSE_NAMES = {"tris": "dense_tri_closest", "any": "dense_tri_any", "spheres": "dense_spheres",
               "spheres_any": "dense_spheres_any", "disks": "dense_disks"}


def dense_time(kind, args, label, empty=None):
    """K3 ("tris", "any"), K4 ("spheres", "spheres_any") or K4a ("disks")
    on the arguments of one main-path launch: the wrapper graph-timed and
    host-paced at its launch shape, every other mode and launch shape the
    wrapper can pick (dense_modes) held bit-equal to its outputs, the plain
    version, the bound and an empty launch; a line printed. -> the kernels
    line's dict."""
    from pbrt_tpu_torch.geometry import intersect as ix

    o, d, t_ = args[:3]
    R = o.shape[0]
    if kind in ("spheres", "spheres_any"):
        any_hit = kind == "spheres_any"
        wrap = lambda: ix.dense_spheres_cuda(*args, any_hit=any_hit)
        plain = lambda: (ix.occluded_spheres_dense_plain(*args) if any_hit
                         else ix.intersect_spheres_dense_plain(*args))
        n_prim = args[3].center.shape[0]
        shape = "wide" if ix.dense_wide(R) else "small"
    elif kind == "disks":
        wrap = lambda: ix.dense_disks_cuda(*args)
        plain = lambda: ix.intersect_disks_dense_plain(*args)
        n_prim = args[3].center.shape[0]
        shape = "wide" if ix.dense_wide(R) else "small"
    else:
        wrap = lambda: ix.dense_tris_cuda(*args, any_hit=kind == "any")
        plain = lambda: (ix.occluded_tris_dense_plain(*args) if kind == "any"
                         else ix.intersect_tris_dense_plain(*args))
        n_prim = args[3].shape[0]
        shape = (f"G{1 if kind == 'any' else ix.dense_tri_group(R, n_prim)} "
                 f"{'wide' if ix.dense_wide(R) else 'small'}")
    ref = wrap()
    ref = ref if kind in ("disks", "spheres") else (ref,)
    fns = dense_modes(kind, args)
    for k, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        if kind in ("any", "spheres_any"):
            same = torch.equal(fn.out[1], ref[0])
        elif kind == "tris":
            same = (torch.equal(fn.out[1], ref[0].prim) and torch.equal(fn.out[0], ref[0].t)
                    and torch.equal(fn.out[2], ref[0].b))
        else:
            same = all(torch.equal(a, b) for a, b in zip(fn.out, ref))
        require(same, kind, label, k, "differs from the wrapper's outputs")
    ms, call = kernel_ms(wrap)
    empty = dense_empty_ms() if empty is None else empty
    ms_plain = events_ms(plain, 3)
    b_ms, by, n_h, note = dense_bound(kind, args)
    name = DENSE_NAMES[kind]
    what = {"disks": "disks", "spheres": "spheres", "spheres_any": "spheres"}.get(kind, "tris")
    log(f"{name} at {label} ({R} lanes x {n_prim} {what}, {note}; {shape}): kernel {ms:.5f} ms "
        f"(host-paced {call:.5f} ms), {ms / b_ms:.2f}x its bound {b_ms:.5f} ms ({by}), "
        f"{ms / empty:.2f}x an empty launch {empty:.5f} ms; plain {ms_plain:.3f} ms; the bits "
        f"of {', '.join(fns)} equal the wrapper's")
    return dict(ms=ms, plain_ms=ms_plain, bound_ms=b_ms, bound_by=by, library_ms=None,
                lanes=R, launch_shape=shape, empty_ms=empty)


def main():
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    from quadric_edges import clip_edge_distance
    from layered_cases import (ATOL, BXDF_FIELDS, CASES as LAYERED_CASES, CLOSE_FRAC,
                               EQUAL_FRAC, MEAN_RTOL, RTOL, blocks, deep_medium_lanes,
                               frac_close, lanes as layered_lanes)
    import bdpt_cases
    import mlt_cases
    import path_cases
    from pbrt_tpu_torch import kernels
    from pbrt_tpu_torch.accel import bvh, dispatch
    from pbrt_tpu_torch.film import film as filmlib, film_kernel, png
    from pbrt_tpu_torch.geometry import intersect as ix
    from pbrt_tpu_torch.integrators import bdpt, mlt, path as pth, render as rd
    from pbrt_tpu_torch.materials import bxdfs, layered
    from pbrt_tpu_torch.parallel import scene_shard as ss
    from pbrt_tpu_torch.sampling import samplers
    from pbrt_tpu_torch.scene import builder as bd, lexer as lx, testscenes as ts
    from pbrt_tpu_torch.scene.compile import compile_scene, load_scene
    from pbrt_tpu_torch.textures import textures as texlib
    from pbrt_tpu_torch.cameras import perspective
    from pbrt_tpu_torch.utils.math import INFINITY

    dev = torch.device("cuda")
    t_start = time.time()
    counters = (bvh.launches, film_kernel.launches, ix.launches, rd.launches, layered.launches,
                bdpt.launches, mlt.launches, ss.launches, pth.launches, texlib.launches)

    phase_t = {}

    def phase_start(name):
        """Log and keep the script's clock at the start of a phase."""
        phase_t[name] = time.time() - t_start
        log(f"[phase {name} starts at {phase_t[name]:.1f} s]")

    def reset_counts():
        for c in counters:
            for k in c:
                c[k] = 0

    def read_counts():
        return {k: v for c in counters for k, v in c.items()}

    # ---- 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.time()
    built = kernels.build()
    for name, (sec, report) in built.items():
        log(f"build {name}: {sec:.1f} s (nvcc {' '.join(kernels.NVCC_FLAGS)})")
        for line in report.splitlines():
            if "Function properties for" in line:
                log(f"  ptxas: {line.split(' for ', 1)[1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    # K5's and K5s's entries and K8 as compiled: the scatter and splat
    # entries' adds must be RED (no returned value), the tiled entry must
    # hold no atomic
    cuobjdump = Path(kernels.nvcc_path()).parent / "cuobjdump"
    checked = set()
    for name in ("film", "wavefront"):
        sass = subprocess.run([str(cuobjdump), "-sass", str(kernels.library_path(name))],
                              capture_output=True, text=True, timeout=120).stdout
        ops = sass_memory_ops(sass)
        for fn, c in ops.items():
            short = next(k for k in ("film_add_scatter_kernel", "film_add_tiled_kernel",
                                     "film_add_splats_kernel", "recycle_kernel") if k in fn)
            checked.add(short)
            log(f"  sass {short}: {dict(sorted(c.items()))}")
            atomics = [k for k in c if k.startswith(("ATOM", "RED"))]
            if short in ("film_add_scatter_kernel", "film_add_splats_kernel"):
                require(atomics and all(k.startswith("RED") for k in atomics),
                        f"{short}'s adds are not RED", atomics)
            elif short == "film_add_tiled_kernel":
                require(not atomics, "the tiled entry holds atomics", atomics)
    require(checked == {"film_add_scatter_kernel", "film_add_tiled_kernel",
                        "film_add_splats_kernel", "recycle_kernel"}, "K5's, K5s's and K8's "
            "kernels in the SASS", checked)
    # K1's and K1i's kernels as compiled (csrc/bvh_wide.cuh wide_kernel and
    # inst_wide_kernel, each in its four instantiations): 16-byte global
    # loads of whole rows, at most 80 registers (6 blocks an SM), and
    # neither a local-memory stack nor spills
    report = built["bvh_traverse"][1].splitlines()
    checked = set()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("bvh_traverse"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        flags = re.search(r"(inst_wide_kernel|wide_kernel)ILb([01])ELb([01])E", fn)
        if flags is None:
            continue
        checked.add(flags.groups())
        short = f"{flags.group(1)}<{'any hit' if flags.group(2) == '1' else 'closest hit'}" + (
            ", stats>" if flags.group(3) == "1" else ">")
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        n_regs = int(re.search(r"Used (\d+) registers", regs).group(1))
        log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
        wide = [k for k in c if k.startswith("LDG") and ".128" in k]
        local = [k for k in c if k.startswith(("LDL", "STL"))]
        require(wide and not local and n_regs <= 80 and frame.startswith(
                    "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
                "K1's or K1i's kernel: no 16-byte loads, over 80 registers, or a local stack or "
                "spills", short, dict(c), frame, regs)
    want = {(k, a, st) for k in ("wide_kernel", "inst_wide_kernel") for a in "01" for st in "01"}
    require(checked == want, "K1's and K1i's instantiations in the SASS", sorted(checked))
    # K11's kernels as compiled (csrc/scene_shard.cu): parts_wide_kernel
    # (K1's loop over the parts under their top level) with 16-byte global
    # loads and neither a local-memory stack nor spills, its registers
    # printed
    report = built["scene_shard"][1].splitlines()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("scene_shard"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        short = "parts_wide_kernel" if "parts_wide_kernel" in fn else None
        if short is None:
            continue
        flags = re.search(short + r"ILb([01])E(?:Lb([01])E)?", fn)
        short += ("<any hit" if flags.group(1) == "1" else "<closest hit") + (
            ", stats>" if flags.group(2) == "1" else ">")
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
        wide = [k for k in c if k.startswith("LDG") and ".128" in k]
        local = [k for k in c if k.startswith(("LDL", "STL"))]
        require(wide and not local and frame.startswith("0 bytes stack frame, 0 bytes spill "
                                                        "stores, 0 bytes spill loads"),
                "K11's kernel: no 16-byte loads, or a local stack or spills", short, dict(c),
                frame)
    # K12's kernels as compiled (csrc/bdpt.cu): the tiled bdpt_connect_weight
    # reads its vertices from shared memory (LDS, staged by LDGSTS) up to 35
    # vertex slots, in place past them; neither instantiation has a
    # local-memory stack or spills. The yardsticks (csrc/bdpt_lane.cu, K12 as
    # first written) are read and printed beside them.
    k12_names = ("connect_weight_tile_kernel", "connect_weight_lane_kernel",
                 "connect_rays_lane_kernel", "connect_rays_kernel")
    for lib_name in ("bdpt", "bdpt_lane"):
        report = built[lib_name][1].splitlines()
        for fn, c in sass_memory_ops(subprocess.run(
                [str(cuobjdump), "-sass", str(kernels.library_path(lib_name))],
                capture_output=True, text=True, timeout=120).stdout).items():
            short = next((k for k in k12_names if k in fn), None)
            if short is None:
                continue
            tiled = short == "connect_weight_tile_kernel"
            media = re.search(r"connect_weight_tile_kernelILb[01]ELb1E|connect_rays_kernelILb1E",
                              fn)
            if tiled:
                short += ("<staged" if "ILb1E" in fn else "<in place") + (
                    ", media>" if media else ">")
            elif short == "connect_rays_kernel":
                short += "<media>" if media else "<>"
            at = next(i for i, line in enumerate(report) if "Function properties for" in line
                      and fn in line)
            frame = report[at + 1].strip()
            regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                        if "registers" in line)
            log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
            if tiled:
                local = [k for k in c if k.startswith(("LDL", "STL"))]
                staged = "ILb1E" in fn
                require(any(k.startswith("LDS") for k in c) == staged and not local
                        and frame.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                                             "spill loads"),
                        "K12's tiled kernel: shared-memory loads not as staged, or a local stack "
                        "or spills", short, dict(c), frame)
    # K7's layered_f, layered_pdf and layered_sample as redesigned
    # (csrc/layered.cu): neither a local-memory stack nor spills; the
    # yardsticks (csrc/layered_lane.cu) printed beside
    k7_kernels = ("f_enter_kernel", "f_walk_kernel", "layered_pdf_kernel",
                  "sample_enter_kernel", "sample_walk_kernel", "layered_f_lane_kernel",
                  "layered_pdf_lane_kernel", "layered_sample_lane_kernel")
    for lib_name in ("layered", "layered_lane"):
        report = built[lib_name][1].splitlines()
        for fn, c in sass_memory_ops(subprocess.run(
                [str(cuobjdump), "-sass", str(kernels.library_path(lib_name))],
                capture_output=True, text=True, timeout=120).stdout).items():
            short = next((k for k in k7_kernels if k in fn), None)
            if short is None:
                continue
            at = next(i for i, line in enumerate(report) if "Function properties for" in line
                      and fn in line)
            frame = report[at + 1].strip()
            regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                        if "registers" in line)
            log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
            if short in k7_kernels[:5]:
                local = [k for k in c if k.startswith(("LDL", "STL"))]
                require(not local and frame.startswith("0 bytes stack frame, 0 bytes spill "
                                                       "stores, 0 bytes spill loads"),
                        "K7's redesigned kernels: a local stack or spills", short, dict(c), frame)
    # K6's kernels as compiled (csrc/path_step.cu): registers, stack frame,
    # spills and local loads and stores of each, printed; path_shade and
    # path_bsdf (the shading kernels as redesigned) with neither a stack
    # frame nor spills, the yardstick path_shade_lane beside them
    report = built["path_step"][1].splitlines()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("path_step"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        short = next((k for k in ("path_rr_kernel", "path_shade_kernel", "path_bsdf_kernel",
                                  "path_shade_lane_kernel", "path_coat_kernel",
                                  "path_resolve_kernel", "path_shade_vol_kernel",
                                  "path_bsdf_vol_kernel", "path_resolve_vol_kernel")
                      if k in fn), None)
        if short is None:
            continue
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        local = {k: v for k, v in c.items() if k.startswith(("LDL", "STL"))}
        log(f"  sass {short}: {dict(sorted(c.items()))}; local loads and stores {local or 0}; "
            f"ptxas: {frame}; {regs}")
        if short in ("path_shade_kernel", "path_bsdf_kernel"):
            require(not local and frame.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                                   "0 bytes spill loads"),
                    "K6's shading kernels: a local stack or spills", short, dict(c), frame)
    # K6t as compiled (csrc/transmit.cu): neither a local-memory stack nor
    # spills, its registers printed
    report = built["transmit"][1].splitlines()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("transmit"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        if "transmit_hop_kernel" not in fn:
            continue
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        local = {k: v for k, v in c.items() if k.startswith(("LDL", "STL"))}
        log(f"  sass transmit_hop_kernel: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
        require(not local and frame.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                               "0 bytes spill loads"),
                "K6t: a local stack or spills", dict(c), frame)
    # K12m's kernels as compiled (csrc/mlt.cu, a lane group a chain): neither
    # a local-memory stack nor spills, the accept kernel's adds RED (no
    # returned value); their registers printed
    report = built["mlt"][1].splitlines()
    checked = set()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("mlt"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        short = next((k for k in ("accept_splat_kernel", "mutate_kernel") if k in fn), None)
        if short is None:
            continue
        checked.add(short)
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
        local = [k for k in c if k.startswith(("LDL", "STL"))]
        atomics = [k for k in c if k.startswith(("ATOM", "RED"))]
        require(not local and frame.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                               "0 bytes spill loads")
                and (short == "mutate_kernel" or atomics and all(k.startswith("RED")
                                                                 for k in atomics)),
                "K12m's kernels: a local stack, spills, or atomics that are not RED", short,
                dict(c), frame)
    require(checked == {"mutate_kernel", "accept_splat_kernel"}, "K12m's kernels in the SASS",
            checked)
    # K3's, K4's and K4a's kernels as compiled (csrc/dense_intersect.cu):
    # every instantiation of dense_tri_kernel (any hit, G: the small-wave
    # mode; closest hit at G 1, 2, 4, 8, any hit at G 1),
    # dense_tri_wide_kernel (any hit), dense_sphere_kernel and
    # dense_sphere_wide_kernel (partial, any hit) and dense_disk_kernel
    # (partial, wide) with neither a local-memory stack nor spills; their
    # registers printed
    report = built["dense_intersect"][1].splitlines()
    checked = set()
    for fn, c in sass_memory_ops(subprocess.run(
            [str(cuobjdump), "-sass", str(kernels.library_path("dense_intersect"))],
            capture_output=True, text=True, timeout=120).stdout).items():
        tri = (re.search(r"dense_tri_kernelILb([01])ELi(\d+)E", fn)
               or re.search(r"dense_tri_(wide)_kernelILb([01])E", fn))
        dsk = re.search(r"dense_disk_kernelILb([01])ELb([01])E", fn)
        sph = re.search(r"dense_sphere_(wide_)?kernelILb([01])ELb([01])E", fn)
        if tri and tri.group(1) == "wide":
            short = f"dense_tri_wide_kernel<{'any hit' if tri.group(2) == '1' else 'closest'}>"
        elif tri:
            short = (f"dense_tri_kernel<{'any hit' if tri.group(1) == '1' else 'closest'}, "
                     f"G {tri.group(2)}>")
        elif dsk:
            short = (f"dense_disk_kernel<{'partial' if dsk.group(1) == '1' else 'full'}, "
                     f"{'wide' if dsk.group(2) == '1' else 'small'}>")
        elif sph:
            short = (f"dense_sphere_{sph.group(1) or ''}kernel<"
                     f"{'partial' if sph.group(2) == '1' else 'full'}, "
                     f"{'any hit' if sph.group(3) == '1' else 'closest'}>")
        else:
            continue
        at = next(i for i, line in enumerate(report) if "Function properties for" in line
                  and fn in line)
        frame = report[at + 1].strip()
        regs = next(line.split(":", 1)[1].strip() for line in report[at + 1:]
                    if "registers" in line)
        local = [k for k in c if k.startswith(("LDL", "STL"))]
        log(f"  sass {short}: {dict(sorted(c.items()))}; ptxas: {frame}; {regs}")
        checked.add(("sphere",) + sph.groups() if sph else tri.groups() if tri else dsk.groups())
        require(not local and frame.startswith("0 bytes stack frame, 0 bytes spill stores, "
                                               "0 bytes spill loads"),
                "K3's, K4's or K4a's kernels: a local stack or spills", short, dict(c), frame)
    want = {("0", str(g)) for g in (1, 2, 4, 8)} | {("1", "1")} | {
        (p_, st) for p_ in "01" for st in "01"} | {("wide", a) for a in "01"} | {
        ("sphere", w, p_, a) for w in (None, "wide_") for p_ in "01" for a in "01"}
    require(checked == want, "K3's, K4's and K4a's instantiations in the SASS",
            sorted(checked, key=str))
    # the samplers' sines and cosines (csrc/bxdf.cuh sin_angle, cos_angle)
    # against the library's sinf and cosf on every float below 105615
    mism = layered.trig_mismatches(dev)
    require(mism == 0, "sin_angle / cos_angle differ from sinf / cosf", mism)
    log(f"bxdf sin_angle and cos_angle against sinf and cosf on every float of magnitude <= "
        f"{layered.TRIG_LIMIT}: {mism} mismatches")
    log(f"build total (nvcc, every source in parallel): {time.time() - t0:.1f} s")

    # sampler streams: bit-exact between the card and the CPU
    pix = torch.arange(4096, dtype=torch.int64) * 7919 % 65536
    smp = torch.arange(4096, dtype=torch.int64) % 16
    for kind in ("independent", "stratified"):
        outs = []
        for d_ in ("cpu", "cuda"):
            r = samplers.start_pixel_sample(pix.to(d_), smp.to(d_))
            r, u2 = samplers.get_2d(r, None, kind, 16)
            r, u1 = samplers.get_1d(r, None, kind, 16)
            outs.append((r.state.cpu(), u2.cpu(), u1.cpu()))
        require(all(torch.equal(a, b) for a, b in zip(*outs)), kind)
    log("sampler streams bit-exact on the card vs CPU: ok")

    g = torch.Generator(device="cpu").manual_seed(1234)

    def camera_and_interior_rays(scene, meta, n_cam=65536, n_in=65536):
        """n_cam camera rays plus n_in random interior rays of the scene's
        triangle bounds; every 97th lane masked (t_max = 0)."""
        p_film = torch.rand((n_cam, 2), generator=g) * torch.tensor(meta.resolution,
                                                                      dtype=torch.float32)
        rays = perspective.generate_rays(scene, p_film.to(dev), torch.zeros((n_cam, 2),
                                                                            device=dev))
        pts = torch.cat([scene.tri_p0, scene.tri_p1, scene.tri_p2]).cpu()
        lo, hi = pts.min(0).values, pts.max(0).values
        o_in = lo + (hi - lo) * (0.05 + 0.9 * torch.rand((n_in, 3), generator=g))
        d_in = torch.randn((n_in, 3), generator=g)
        d_in = d_in / d_in.norm(dim=-1, keepdim=True)
        o = torch.cat([rays.o, o_in.to(dev)]).contiguous()
        d = torch.cat([rays.d, d_in.to(dev)]).contiguous()
        t_max = torch.full((o.shape[0],), INFINITY, device=dev)
        t_max[::97] = 0.0
        return o, d, t_max

    def shadow_t(t_closest):
        """Shadow-ray lengths in [0, 2 t_closest], every 89th lane masked."""
        u = torch.rand(t_closest.shape[0], generator=g).to(dev)
        t = torch.where(t_closest < INFINITY, t_closest * 2.0 * u, 1e3)
        t[::89] = 0.0
        return t.contiguous()

    phase_start("3")
    # ---- 3. BVH traversal vs plain on camera + interior rays, cornell-mesh l5
    scene, meta = compile_scene(ts.cornell_mesh_builder(levels=5, res=256), 16, device=dev)
    rows, n_int, depth = scene.bvh_rows, meta.bvh_nint, meta.bvh_depth
    log(f"cornell-mesh levels 5: {meta.n_tris} tris, {rows.shape[0]} rows "
        f"({rows.numel() * 4 / 1e6:.2f} MB), depth {depth}")
    o, d, t_max = camera_and_interior_rays(scene, meta)
    ov0 = int(bvh.overflow_counter(dev).item())

    def timed(fn):
        """(fn(), its milliseconds between CUDA events)"""
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b)

    def compare_closest(o, d, t_max, sc=None, mt=None):
        """K1 vs plain closest hit on the scene (sc, mt) (default: this
        phase's cornell-mesh); differing winners must be verified ties. ->
        (hits, ties, max rel err of t, of b, max abs err of t, plain t,
        plain ms)."""
        sc, mt = (scene, meta) if sc is None else (sc, mt)
        rows_, nint_ = sc.bvh_rows, mt.bvh_nint
        _, p_k = bvh.traverse_cuda(rows_, nint_, mt.bvh_depth, o, d, t_max)
        (t_p, p_p), ms_p = timed(lambda: bvh.traverse_plain(rows_, nint_, o, d, t_max))
        require(torch.equal(p_k >= 0, p_p >= 0), "closest hit: hit/miss disagree")

        def refit(prim):
            pc = prim.clamp(min=0)
            return ix.intersect_tri_lanes(o, d, t_max, sc.tri_p0[pc], sc.tri_p1[pc],
                                          sc.tri_p2[pc])

        tr_k, b_k, ok_k = refit(p_k)
        tr_p, b_p, ok_p = refit(p_p)
        hit = p_p >= 0
        differ = hit & (p_k != p_p)
        if bool(differ.any()):
            require(bool((ok_k[differ] & ok_p[differ]).all()), "different winner that misses")
            rel = (tr_k[differ] - tr_p[differ]).abs() / tr_p[differ].abs()
            require(float(rel.max()) <= 1e-6, "prim disagreement is not a tie",
                    float(rel.max()))
        same = hit & ~differ
        t_err = float(((tr_k - tr_p).abs() / tr_p.abs().clamp(min=1e-6))[same].max())
        b_err = float((b_k - b_p).abs()[same].max())
        require(t_err <= 1e-5 and b_err <= 1e-5, "t/b disagree", t_err, b_err)
        return (int(hit.sum()), int(differ.sum()), t_err, b_err,
                float((tr_k - tr_p).abs()[same].max()), t_p, ms_p)

    def compare_any(o, d, t_max, sc=None, mt=None):
        """K1a vs plain any hit: equal. -> (the plain version's occluded
        mask, plain ms)."""
        sc, mt = (scene, meta) if sc is None else (sc, mt)
        _, pa_k = bvh.traverse_cuda(sc.bvh_rows, mt.bvh_nint, mt.bvh_depth, o, d, t_max,
                                    any_hit=True)
        (_, pa_p), ms_p = timed(lambda: bvh.traverse_plain(sc.bvh_rows, mt.bvh_nint, o, d, t_max,
                                                           any_hit=True))
        n_diff = int(((pa_k >= 0) != (pa_p >= 0)).sum())
        require(n_diff == 0, "occluded disagrees on", n_diff)
        return pa_p >= 0, ms_p

    n_hit, n_ties, t_err, b_err, _, t_cl, _ = compare_closest(o, d, t_max)
    n_occ = int(compare_any(o, d, shadow_t(t_cl))[0].sum())
    log(f"bvh vs plain on {o.shape[0]} camera+interior rays: {n_hit} hits, {n_ties} ties "
        f"(verified), max rel err t {t_err:.2e} b {b_err:.2e}; any hit {n_occ} occluded, "
        f"0 disagree")

    phase_start("4")
    # ---- 4. film kernels vs plain with NaN lanes, zero pdfs and zero
    # weights, 256^2 film
    n_lanes, n_px = 131072, 256 * 256
    pix = torch.randint(0, n_px, (n_lanes,), generator=g).to(dev)
    L = (torch.rand((n_lanes, 4), generator=g) * 3.0).to(dev)
    lam = (360.0 + 470.0 * torch.rand((n_lanes, 4), generator=g)).to(dev)
    pdf = (0.001 + 0.004 * torch.rand((n_lanes, 4), generator=g)).to(dev)
    pdf[::37, 1] = 0.0
    L[::53, 2] = float("nan")
    w = (torch.rand(n_lanes, generator=g) * 2.0 - 0.5).to(dev)
    w[::5] = 0.0

    def compare_film(args):
        """K5's scatter entry vs its plain version into fresh 256^2 films ->
        max abs err."""
        fk, fp = filmlib.new_film((256, 256), dev), filmlib.new_film((256, 256), dev)
        film_kernel.add_samples_cuda(fk.rgb_sum, fk.weight_sum, *args)
        film_kernel.add_samples_plain(fp.rgb_sum, fp.weight_sum, *args)
        scale = float(fp.rgb_sum.abs().max())
        err = max(float((fk.rgb_sum - fp.rgb_sum).abs().max()),
                  float((fk.weight_sum - fp.weight_sum).abs().max()))
        require(torch.allclose(fk.rgb_sum, fp.rgb_sum, rtol=1e-5, atol=1e-6 * scale), err)
        require(torch.allclose(fk.weight_sum, fp.weight_sum, rtol=1e-5, atol=1e-6), err)
        return err

    def compare_tiled(args, k):
        """K5's tiled entry vs its plain version into fresh 256^2 films: bit
        for bit."""
        fk, fp = filmlib.new_film((256, 256), dev), filmlib.new_film((256, 256), dev)
        film_kernel.add_samples_tiled_cuda(fk.rgb_sum, fk.weight_sum, *args, k)
        film_kernel.add_samples_tiled_plain(fp.rgb_sum, fp.weight_sum, *args, k)
        err = max(float((fk.rgb_sum - fp.rgb_sum).abs().max()),
                  float((fk.weight_sum - fp.weight_sum).abs().max()))
        require(torch.equal(fk.rgb_sum, fp.rgb_sum) and torch.equal(fk.weight_sum, fp.weight_sum),
                "tiled film add differs from its plain version", err)
        return err

    film_err = compare_film((pix, L, lam, pdf, w))
    log(f"film_add_scatter vs plain on {n_lanes} lanes with NaN/zero-pdf/zero-weight lanes: max "
        f"abs err {film_err:.2e} (rtol 1e-5: atomic order)")
    compare_tiled((torch.arange(n_px, device=dev), L, lam, pdf, w), n_lanes // n_px)
    log(f"film_add_samples (tiled) vs plain on {n_lanes // n_px} replicates of the {n_px} pixel "
        f"ids with NaN/zero-pdf/zero-weight lanes: bit-exact (group of "
        f"{film_kernel.tile_group(n_px, n_lanes // n_px)} lanes a pixel)")

    def compare_splats(args):
        """K5s vs its plain version into fresh 256^2 films -> max abs err."""
        fk, fp = filmlib.new_film((256, 256), dev), filmlib.new_film((256, 256), dev)
        film_kernel.add_splats_cuda(fk.splat, *args)
        film_kernel.add_splats_plain(fp.splat, *args)
        scale = float(fp.splat.abs().max())
        err = float((fk.splat - fp.splat).abs().max())
        require(torch.allclose(fk.splat, fp.splat, rtol=1e-5, atol=1e-6 * scale), "K5s", err)
        return err

    # three strategies' splats over one wave's lanes: wavelength row i % n_lam
    n_lam = n_lanes // 3
    splat_err = compare_splats((pix[:3 * n_lam], L[:3 * n_lam], lam[:n_lam], pdf[:n_lam]))
    log(f"film_add_splats vs plain on {3 * n_lam} splats over {n_lam} lanes' wavelengths with "
        f"NaN/zero-pdf lanes: max abs err {splat_err:.2e} (rtol 1e-5: atomic order)")

    phase_start("5")
    # ---- 5. dense kernels (K3, K4) vs plain
    def compare_dense_tris(o, d, t_max, tris, any_hit=False):
        """K3 vs plain: prim ids, t and barycentrics bit for bit; any hit
        identical. -> (lanes hit or occluded, max abs err of t)."""
        if any_hit:
            k = ix.dense_tris_cuda(o, d, t_max, *tris, any_hit=True)
            require(torch.equal(k, ix.occluded_tris_dense_plain(o, d, t_max, *tris)),
                    "dense any hit disagrees")
            return int(k.sum()), 0.0
        k = ix.dense_tris_cuda(o, d, t_max, *tris)
        p = ix.intersect_tris_dense_plain(o, d, t_max, *tris)
        require(torch.equal(k.prim, p.prim), "dense tri prim ids differ",
                int((k.prim != p.prim).sum()))
        require(torch.equal(k.t, p.t) and torch.equal(k.b, p.b), "dense tri t/b differ")
        return int((p.prim >= 0).sum()), 0.0

    def compare_quadrics(kind, o, d, t_max, soa):
        """K4 vs plain: winners equal but on lanes within 1e-5 of a clip edge
        (atan2f vs torch.atan2); t, p, n to 1e-6 relative. -> (hits,
        edge disagreements, max abs err of t)."""
        cuda_fn = ix.dense_spheres_cuda if kind == "spheres" else ix.dense_disks_cuda
        plain_fn = (ix.intersect_spheres_dense_plain if kind == "spheres"
                    else ix.intersect_disks_dense_plain)
        tk, ik, pk, nk = cuda_fn(o, d, t_max, soa)
        tp, ip, pp, np_ = plain_fn(o, d, t_max, soa)
        differ = ik != ip
        n_edge = int(differ.sum())
        if n_edge:
            margin = clip_edge_distance(o[differ], d[differ],
                                        soa if kind == "spheres" else None,
                                        soa if kind == "disks" else None)
            require(bool((margin < 1e-5).all()), f"{kind}: a disagreement off the clip edges",
                    float(margin.max()))
        same = ~differ & (ip >= 0)
        require(torch.allclose(tk[same], tp[same], rtol=1e-6), kind, "t differs")
        require(torch.allclose(pk[same], pp[same], rtol=1e-6, atol=1e-6), kind, "p differs")
        require(torch.allclose(nk[same], np_[same], rtol=1e-6, atol=1e-6), kind, "n differs")
        err = float((tk[same] - tp[same]).abs().max()) if bool(same.any()) else 0.0
        if kind == "spheres":
            compare_sphere_any(o, d, t_max, soa, ik)
        return int((ip >= 0).sum()), n_edge, err

    def compare_sphere_any(o, d, t_max, soa, idx=None):
        """K4's any-hit entry: its bools the closest-hit entry's idx >= 0 bit
        for bit, and the plain version's but on lanes within 1e-5 of a clip
        edge. -> lanes occluded."""
        if idx is None:
            idx = ix.dense_spheres_cuda(o, d, t_max, soa)[1]
        k = ix.dense_spheres_cuda(o, d, t_max, soa, any_hit=True)
        require(k.dtype == torch.bool and torch.equal(k, idx >= 0),
                "spheres: the any-hit entry differs from the closest hit's idx >= 0",
                int((k != (idx >= 0)).sum()))
        differ = k != ix.occluded_spheres_dense_plain(o, d, t_max, soa)
        if bool(differ.any()):
            margin = clip_edge_distance(o[differ], d[differ], soa, None)
            require(bool((margin < 1e-5).all()), "spheres any hit: a disagreement off the clip "
                    "edges", float(margin.max()))
        return int(k.sum())

    s_corn, m_corn = ts.cornell(res=256, spp=16, device=dev)
    s_caus, m_caus = load_scene(str(ROOT / "scenes" / "caustic-glass.pbrt"), device=dev,
                                spp=4, integrator="path")
    for label, sc, mt in (("cornell", s_corn, m_corn), ("caustic-glass", s_caus, m_caus)):
        o, d, t_max = camera_and_interior_rays(sc, mt)
        tris = (sc.tri_p0, sc.tri_p1, sc.tri_p2)
        n_h, _ = compare_dense_tris(o, d, t_max, tris)
        t_cl = ix.intersect_tris_dense_plain(o, d, t_max, *tris).t
        n_o, _ = compare_dense_tris(o, d, shadow_t(t_cl), tris, any_hit=True)
        msg = f"dense kernels vs plain on {label} ({o.shape[0]} rays): tris {n_h} hits " \
              f"(prim/t/b bit-exact), {n_o} occluded (identical)"
        sph_s = ix.SphereSoA(sc.sph_center, sc.sph_radius, table=sc.sph_table)
        n_s = compare_quadrics("spheres", o, d, t_max, sph_s)
        n_so = compare_sphere_any(o, d, shadow_t(t_cl), sph_s)
        msg += (f"; spheres {n_s[0]} hits, max abs err t {n_s[2]:.2e}, any hit {n_so} occluded "
                f"on shadow rays (the closest hit's idx >= 0, bit for bit)")
        if mt.n_disks:
            n_d = compare_quadrics("disks", o, d, t_max, ix.DiskSoA(
                sc.dsk_center, sc.dsk_normal, sc.dsk_radius, sc.dsk_inner, table=sc.dsk_table))
            msg += f"; disks {n_d[0]} hits, max abs err t {n_d[2]:.2e}"
        log(msg)

    # synthetic partial quadrics in [-1, 1]^3, masked and short lanes
    rng = np.random.default_rng(7)
    nq = 32
    rot = np.linalg.qr(rng.normal(size=(nq, 3, 3)))[0]
    rad = rng.uniform(0.1, 0.4, nq)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)
    sph_p = ix.with_table(ix.SphereSoA(f(rng.uniform(-0.8, 0.8, (nq, 3))), f(rad), f(rot),
                         f(-rad * rng.uniform(0.2, 1.0, nq)), f(rad * rng.uniform(0.2, 1.0, nq)),
                         f(rng.uniform(1.0, 2 * np.pi, nq))))
    dsk_p = ix.with_table(ix.DiskSoA(f(rng.uniform(-0.8, 0.8, (nq, 3))), f(rot[:, 2]), f(rad),
                       f(rad * rng.uniform(0.0, 0.5, nq)), f(rot[:, 0]),
                       f(np.cross(rot[:, 2], rot[:, 0])), f(rng.uniform(1.0, 2 * np.pi, nq))))
    o_q = f(rng.uniform(-1.0, 1.0, (131072, 3)))
    d_q = f(rng.normal(size=(131072, 3)))
    d_q = (d_q / d_q.norm(dim=-1, keepdim=True)).contiguous()
    t_q = torch.full((131072,), INFINITY, device=dev)
    t_q[::13] = 0.0
    t_q[5::13] = f(rng.uniform(0.0, 2.0, t_q[5::13].shape[0]))
    for kind, soa in (("spheres", sph_p), ("disks", dsk_p)):
        n_h, n_edge, err = compare_quadrics(kind, o_q, d_q, t_q, soa)
        log(f"partial {kind} ({nq}) vs plain on 131072 rays: {n_h} hits, {n_edge} "
            f"disagreements, all within 1e-5 of a clip edge; max abs err t {err:.2e}"
            + ("; the any-hit entry the closest hit's idx >= 0 bit for bit" if kind == "spheres"
               else ""))

    phase_start("6")
    # ---- 6. K8 vs torch.cumsum's plain version at the pool size and at a
    # size that is not a multiple of its tile, with and without the rank,
    # back to back on the kernel's scratch
    # the masks at the pool size come from the script's generator g, as
    # before this phase was extended; the two calls at a size that is not a
    # multiple of the tile draw from their own, so that every later phase
    # gets the random numbers it got before
    R = rd.POOL_LANES
    g6 = torch.Generator(device="cpu").manual_seed(6)
    for i, (density, left, gen, R_i) in enumerate((
            (0.03, 10 ** 7, g, R), (0.5, 10 ** 7, g, R), (0.5, 1000, g, R), (1.0, 0, g, R),
            (0.4, -3, g, R), (0.6, 2, g6, R - 1234), (0.5, 1, g6, R - 1234))):
        in_flight = (torch.rand(R_i, generator=gen) < 0.95).to(dev)
        finished = in_flight & (torch.rand(R_i, generator=gen) < density).to(dev)
        total = 1 << 26
        ck = torch.tensor([total - left, 0], dtype=torch.int64, device=dev)
        cp = ck.clone()
        out_k = rd.recycle_cuda(finished, in_flight, ck, total, with_rank=i % 2 == 0)
        out_p = rd.recycle_plain(finished, in_flight, cp, total, with_rank=i % 2 == 0)
        require(all(a is b is None or (a.dtype == b.dtype and torch.equal(a, b))
                    for a, b in zip(out_k, out_p)) and torch.equal(ck, cp),
                "recycle differs from cumsum", density, left, R_i)
    log(f"wavefront_recycle vs torch.cumsum at {R} and {R - 1234} lanes, 7 masks back to back "
        f"(next_work up to 3 past the end, rank on every other call): rank, work, recycle, "
        f"in_flight and counters bit-exact")

    phase_start("6b")
    # ---- 6b. K7 vs plain on synthetic lanes
    def sub_params(p, idx):
        def bx(b):
            return bxdfs.BxdfParams(*(x[idx] for x in b))
        return layered.LayeredParams(bx(p.top), bx(p.bottom), p.thickness[idx], p.g[idx],
                                     p.albedo[idx], p.max_depth, p.n_samples)

    def compare_layered(name, p, args, mask=None):
        """K7 entry point `name` against its plain version on the lanes of
        `mask` (all lanes when None), held to the statistical criteria of
        the module docstring. -> {lanes, agreement fraction of each output,
        mean_rel: relative difference of the lane means, max_abs_err: the
        largest error of f (or pdf) among the lanes within tolerance}."""
        out_k = getattr(layered, f"{name}_cuda")(p, *args, mask)
        idx = (torch.arange(args[0].shape[0], device=dev) if mask is None
               else mask.nonzero()[:, 0])
        out_p = getattr(layered, f"{name}_plain")(sub_params(p, idx), *(a[idx] for a in args))
        res = {"lanes": int(idx.shape[0])}
        if name == "layered_sample":
            k = bxdfs.BSDFSample(*(x[idx] for x in out_k))
            for f in ("valid", "flags"):
                res[f] = float((getattr(k, f) == getattr(out_p, f)).float().mean())
                require(res[f] >= EQUAL_FRAC, name, f, res[f])
            pairs = {f: (getattr(k, f), getattr(out_p, f)) for f in ("f", "wi", "pdf")}

            def est(s):
                return torch.where(s.valid[:, None], s.f * s.wi[:, 2:3].abs()
                                   / s.pdf.clamp(min=1e-12)[:, None], 0.0)
            means = (est(k), est(out_p))
        else:
            k = out_k[idx]
            pairs = {"f" if name == "layered_f" else "pdf": (k, out_p)}
            means = (k, out_p)
        err = 0.0
        for f, (a, b) in pairs.items():
            res[f] = frac_close(a, b)
            require(res[f] >= CLOSE_FRAC, name, f, res[f])
            d = (a.double() - b.double()).abs().reshape(a.shape[0], -1)
            ok = (d <= ATOL + RTOL * b.double().abs().reshape(b.shape[0], -1)).all(1)
            if f != "wi" and bool(ok.any()):
                err = max(err, float(d[ok].max()))
        m_k, m_p = float(means[0].double().mean()), float(means[1].double().mean())
        res["mean_rel"] = abs(m_k - m_p) / max(abs(m_p), 1e-30)
        require(res["mean_rel"] <= MEAN_RTOL, name, "lane means differ", m_k, m_p)
        res["max_abs_err"] = err
        return res

    def agreement(res):
        return ", ".join(f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
                         for k, v in res.items())

    n7 = 1 << 18
    lanes7 = {k: torch.as_tensor(v, device=dev) for k, v in layered_lanes(n7, 11).items()}

    def bx7(tag):
        return bxdfs.BxdfParams(*(lanes7[f"{tag}_{f}"] for f in BXDF_FIELDS))
    p7 = layered.LayeredParams(bx7("top"), bx7("bottom"), lanes7["thickness"], lanes7["g"],
                               lanes7["albedo"], 10, 1)
    layered_err = {}
    for name, args in (("layered_f", (lanes7["wo"], lanes7["wi"])),
                       ("layered_sample", (lanes7["wo"], lanes7["uc"], lanes7["u2"])),
                       ("layered_pdf", (lanes7["wo"], lanes7["wi"]))):
        res = compare_layered(name, p7, args)
        layered_err[name] = res["max_abs_err"]
        log(f"{name} vs plain on {n7} synthetic lanes ({len(LAYERED_CASES)} cases: "
            f"{'; '.join(LAYERED_CASES)}): {agreement(res)}")

    def same_bits(a, b):
        """a tensor, or a tuple of them, the same bits as b"""
        if isinstance(a, tuple):
            return all(same_bits(x, y) for x, y in zip(a, b))
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)

    def k7_yardstick(name, p, args, mask, label):
        """layered_f, layered_sample or layered_pdf against its yardstick
        (the kernel as first written, csrc/layered_lane.cu): every output bit
        and the step counts equal. -> the steps counted."""
        st_k, st_y = (torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2))
        out_k = getattr(layered, f"{name}_cuda")(p, *args, mask, st_k)
        out_y = getattr(layered, f"{name}_lane_cuda")(p, *args, mask, st_y)
        same = same_bits(out_k, out_y)
        require(same and int(st_k) == int(st_y), name, label,
                "differs from its yardstick's bits or steps", int(st_k), int(st_y))
        return int(st_k)

    def k7_turns(name, p, args, mask):
        """A K7 entry graph-timed twice -> (kernel ms, the two times). Its
        yardstick is held to its bits (k7_yardstick) and not timed: PERF.md
        records the two in turns."""
        new_fn = getattr(layered, f"{name}_cuda")
        turns = [graph_ms(lambda: new_fn(p, *args, mask)) for _ in range(2)]
        return (turns[0] + turns[1]) / 2, turns

    # the yardsticks' bits on all-coated lanes, the synthetic ones and a
    # deep medium, whose walks run to max_depth; the kernels timed
    lanes_deep = {k: torch.as_tensor(v, device=dev)
                  for k, v in deep_medium_lanes(n7, 11).items()}
    p_deep = layered.LayeredParams(
        *(bxdfs.BxdfParams(*(lanes_deep[f"{tag}_{f}"] for f in BXDF_FIELDS))
          for tag in ("top", "bottom")), lanes_deep["thickness"], lanes_deep["g"],
        lanes_deep["albedo"], 10, 1)
    k7_synthetic = {}
    for label, p_, l_ in (("synthetic", p7, lanes7), ("deep medium", p_deep, lanes_deep)):
        for name in ("layered_f", "layered_sample", "layered_pdf"):
            args = ((l_["wo"], l_["uc"], l_["u2"]) if name == "layered_sample"
                    else (l_["wo"], l_["wi"]))
            n_steps = k7_yardstick(name, p_, args, None, label)
            ms_k, turns = k7_turns(name, p_, args, None)
            k7_synthetic[f"{name} {label}"] = dict(ms=ms_k, turns=turns)
            log(f"{name} on {n7} all-coated {label} lanes: the yardstick's bits and step counts "
                f"({n_steps} "
                f"{'reached the base' if name == 'layered_pdf' else 'steps'}); kernel "
                f"{turns[0]:.4f} / {turns[1]:.4f} ms")

    phase_start("7")
    # ---- 7. small renders vs golden and vs CPU
    goldens = np.load(ROOT / "tests" / "goldens.npz")
    for label, (sc, mt), key in (
            ("cornell-mesh l3 48^2 x 4", compile_scene(
                ts.cornell_mesh_builder(levels=3, res=48, filter_kind="box"), 4, device=dev),
             "cornell_mesh_l3_48_spp4"),
            ("cornell 64^2 x 8", ts.cornell(res=64, spp=8, device=dev, filter_kind="box"),
             "cornell_path_64_spp8")):
        img_gpu = rd.render(sc, mt).cpu().numpy()
        img_cpu = rd.render(sc, mt, device="cpu").numpy()
        fb_g = check_image(img_gpu, goldens[key], f"{label} vs golden")
        fb_c = check_image(img_gpu, img_cpu, f"{label} vs cpu render")
        log(f"small render {label}: vs golden {fb_g:.4%} bad px, vs cpu {fb_c:.4%} bad px, "
            f"means {img_gpu.mean():.5f} / {goldens[key].mean():.5f} / {img_cpu.mean():.5f}")

    # the layered kernel's path at a small size: material-testball 32^2 x 4,
    # box filter, card against CPU (independent walks: block means)
    b_tb = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "material-testball.pbrt"))
    b_tb.film["xresolution"] = b_tb.film["yresolution"] = 32
    b_tb.filter = {"type": "box"}
    s_tb32, m_tb32 = compile_scene(b_tb, 4, device=dev)
    k7 = ("layered_f", "layered_sample", "layered_pdf")
    k7_yard = ("layered_f_lane", "layered_pdf_lane", "layered_sample_lane")
    reset_counts()
    img_t, st_t = rd.render(s_tb32, m_tb32, return_stats=True)
    counts = {k: v for k, v in read_counts().items() if v}
    require(all(counts.get(k, 0) > 0 for k in k7) and not any(counts.get(k) for k in k7_yard),
            "K7 not launched, or its yardsticks launched", counts)
    # the same frame with K7's entries pointed at their yardsticks (the
    # kernels as first written): the same film bits and rays
    swapped = {k: getattr(layered, f"{k}_cuda") for k in k7}
    for k in swapped:
        setattr(layered, f"{k}_cuda", getattr(layered, f"{k}_lane_cuda"))
    try:
        reset_counts()
        img_y, st_y = rd.render(s_tb32, m_tb32, return_stats=True)
        counts_y = {k: v for k, v in read_counts().items() if v}
    finally:
        for k, fn in swapped.items():
            setattr(layered, f"{k}_cuda", fn)
    require(torch.equal(img_t, img_y) and st_t == st_y and all(counts_y.get(k) for k in k7_yard)
            and not any(counts_y.get(k) for k in k7),
            "material-testball 32^2 x 4: the redesigned K7 and its yardsticks render apart",
            st_t, st_y, counts_y)
    log(f"material-testball 32^2 x 4 spp box rendered again with layered_f, layered_sample "
        f"and layered_pdf pointed at their yardsticks (launches {counts_y}): the same image bits and rays "
        f"{ {k: int(v) for k, v in st_t.items()} }")
    img_gpu = img_t.cpu().numpy()
    img_cpu = rd.render(s_tb32, m_tb32, device="cpu").numpy()
    px_bad = float((np.abs(img_gpu - img_cpu) > 5e-3 + 0.05 * np.abs(img_cpu)).mean())
    fb_c = check_image(blocks(img_gpu, 16), blocks(img_cpu, 16),
                       "material-testball vs cpu render (16x16 block means)")
    log(f"material-testball 32^2 x 4 spp box: launches {counts}; vs cpu on 16x16 block means "
        f"{fb_c:.4%} bad, per pixel {px_bad:.4%} bad (independent walks), means "
        f"{img_gpu.mean():.5f} / {img_cpu.mean():.5f}")

    # BDPT at small sizes: cornell against the golden and the CPU, caustic-
    # glass (its own BDPT settings, disk light) and cornell-mesh (the BVH
    # route) against the CPU
    b_cg = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    b_cg.film["xresolution"] = b_cg.film["yresolution"] = 32
    for label, (sc, mt), key in (
            ("cornell bdpt 24^2 x 8", ts.cornell(res=24, spp=8, device=dev, filter_kind="box",
                                                 integrator="bdpt"), "cornell_bdpt_24_spp8"),
            ("caustic-glass bdpt 32^2 x 4", compile_scene(b_cg, 4, device=dev), None),
            ("cornell-mesh l3 bdpt 48^2 x 4", compile_scene(
                ts.cornell_mesh_builder(levels=3, res=48, filter_kind="box"), 4, device=dev,
                integrator_override="bdpt"), None)):
        require(mt.integrator == "bdpt", label)
        reset_counts()
        img_gpu, st_gpu = rd.render(sc, mt, return_stats=True)
        img_gpu = img_gpu.cpu().numpy()
        counts = {k: v for k, v in read_counts().items() if v}
        require(all(counts.get(k, 0) > 0 for k in ("bdpt_connect_rays", "bdpt_connect_weight",
                                                   "film_add_splats")), label, counts)
        img_cpu, st_cpu = rd.render(sc, mt, device="cpu", return_stats=True)
        img_cpu = img_cpu.numpy()
        fb_c = check_image(img_gpu, img_cpu, f"{label} vs cpu render")
        msg = f"small render {label}: vs cpu {fb_c:.4%} bad px"
        if key:
            msg += f", vs golden {check_image(img_gpu, goldens[key], f'{label} vs golden'):.4%}"
        n_g, n_c = sum(st_gpu.values()), sum(st_cpu.values())
        require(abs(n_g - n_c) <= 1e-3 * n_c, label, "ray counts", st_gpu, st_cpu)
        log(f"{msg}; rays card {n_g} cpu {n_c}; means {img_gpu.mean():.5f} / "
            f"{img_cpu.mean():.5f}; launches {counts}")

    phase_start("8")
    # ---- 8. full-width renders through the normal entry point, each once,
    # with the launch counts set to 0 just before it and read just after. The
    # render keeps a copy of the arguments of each kernel's first launch (the
    # shapes and data the main path gives the kernels, for phase 9); its wall
    # time includes those copies.
    patches = [
        (bvh, "traverse_cuda",
         lambda a, k: "bvh_any_hit" if (a[6] if len(a) > 6 else k.get("any_hit"))
         else "bvh_closest_hit"),
        (film_kernel, "add_samples_tiled_cuda", lambda a, k: "film_add_samples"),
        (film_kernel, "add_samples_cuda", lambda a, k: "film_add_scatter"),
        (ix, "dense_tris_cuda",
         lambda a, k: "dense_tri_any" if k.get("any_hit") else "dense_tri_closest"),
        (ix, "dense_spheres_cuda",
         lambda a, k: "dense_spheres_any" if (a[4] if len(a) > 4 else k.get("any_hit"))
         else "dense_spheres"),
        (ix, "dense_disks_cuda", lambda a, k: "dense_disks"),
        (rd, "recycle_cuda", lambda a, k: "wavefront_recycle"),
        (layered, "layered_f_cuda", lambda a, k: "layered_f"),
        (layered, "layered_sample_cuda", lambda a, k: "layered_sample"),
        (layered, "layered_pdf_cuda", lambda a, k: "layered_pdf"),
        (film_kernel, "add_splats_cuda", lambda a, k: "film_add_splats"),
        (bdpt, "connect_rays_cuda", lambda a, k: "bdpt_connect_rays"),
        (bdpt, "connect_weight_cuda", lambda a, k: "bdpt_connect_weight"),
        (bdpt, "connect_all_cuda", lambda a, k: "bdpt_wave"),
        (mlt, "mutate_cuda", lambda a, k: "mlt_mutate"),
        (mlt, "accept_and_splat_cuda", lambda a, k: "mlt_accept_splat"),
        (ss, "closest_parts_cuda", lambda a, k: "bvh_closest_hit_parts"),
        (ss, "any_parts_cuda", lambda a, k: "bvh_any_hit_parts"),
        (ss, "select_cuda", lambda a, k: "shard_select"),
        (bvh, "traverse_inst_cuda",
         lambda a, k: "bvh_any_hit_inst" if (a[8] if len(a) > 8 else k.get("any_hit"))
         else "bvh_closest_hit_inst"),
        (bvh, "refit_cuda", lambda a, k: "bvh_refit"),
        (pth, "rr_cuda", lambda a, k: "path_rr"),
        (pth, "shade_cuda", lambda a, k: "path_shade"),
        (pth, "coat_cuda", lambda a, k: "path_coat"),
        (pth, "resolve_cuda", lambda a, k: "path_resolve"),
        (pth, "shade_vol_cuda", lambda a, k: "path_shade_vol"),
        (pth, "resolve_vol_cuda", lambda a, k: "path_resolve_vol"),
        (pth, "transmit_hop_cuda", lambda a, k: "transmit_hop"),
        (texlib, "eval_lanes_cuda", lambda a, k: "tex_eval"),
        (bdpt, "connect_segments_cuda", lambda a, k: "bdpt_connect_segments"),
    ]
    captured = {}
    # the K1 launches whose third call is kept too: the bounce rays; and
    # K6's third bounce (terrain: the wavefront loop's third iteration);
    # every shading and layered_sample launch of staircase's first wave
    # (its bounces, replayed in phase 9 for a frame's totals)
    K6 = ("path_rr", "path_shade", "path_bsdf", "path_resolve")
    K6C = K6 + ("path_coat",)
    third = {("cornell_mesh", "bvh_closest_hit"), ("cornell_mesh", "bvh_any_hit"),
             ("staircase", "bvh_closest_hit"), ("staircase", "bvh_any_hit")} | {
        (tag, k) for tag in ("cornell_mesh", "cornell", "terrain") for k in K6} | {
        (tag, k) for tag in ("staircase", "testball") for k in K6C} | {
        ("vol_path", "path_shade_vol")}
    wave_kept = {("staircase", "path_shade"), ("staircase", "layered_sample")}
    # the first BDPT wave's walk launches of K4 (2 max_depth + 1), timed as a
    # sum in phase 9, and of K13, held to its plain version in phase 14
    walk_kept = {("caustic_bdpt", "dense_spheres"), ("tex_bdpt", "tex_eval")}
    n_calls = {}

    clone = path_cases.clone

    def render_captured(tag, sc, mt, **kw):
        """One render with each kernel's first-launch arguments kept."""
        origs = []
        for mod, name, key_fn in patches:
            orig = getattr(mod, name)
            origs.append((mod, name, orig))

            def wrapped(*a, _orig=orig, _key=key_fn, **k):
                # the film kernel adds into its first two arguments in place
                first_args = captured.setdefault(tag, {})
                key = _key(a, k)
                n = n_calls[tag, key] = n_calls.get((tag, key), 0) + 1
                if n == 1 or (n == 3 and (tag, key) in third) or (
                        (tag, key) in wave_kept and n <= mt.max_depth) or (
                        (tag, key) in walk_kept and n <= 2 * mt.max_depth + 1):
                    first_args[key if n == 1 else f"{key}#{n}"] = (
                        tuple(clone(x) for x in a), {m: clone(v) for m, v in k.items()}, _orig)
                return _orig(*a, **k)

            setattr(mod, name, wrapped)
        try:
            return rd.render(sc, mt, **kw)
        finally:
            for mod, name, orig in origs:
                setattr(mod, name, orig)

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    main_counts, main_counts_frame, frame_means, frame_imgs, frame_peaks = {}, {}, {}, {}, {}
    frame_counts, frame_walls = {}, {}

    # the path integrator's evaluations of an MLT frame (mlt.eval_x), counted
    # by this script's wrapper: K6 launches max_depth times one
    mlt_evals = {"n": 0, "bdpt": 0}
    eval_x, eval_x_bdpt = mlt.eval_x, mlt.eval_x_bdpt

    def counted_eval_x(*a, **k):
        mlt_evals["n"] += 1
        return eval_x(*a, **k)

    def counted_eval_x_bdpt(*a, **k):
        mlt_evals["bdpt"] += 1
        return eval_x_bdpt(*a, **k)

    mlt.eval_x, mlt.eval_x_bdpt = counted_eval_x, counted_eval_x_bdpt
    # the volumetric scenes' kernels: the VOLUMETRIC K6 variants and K6t
    K6V = ("path_shade_vol", "path_bsdf_vol", "path_resolve_vol", "transmit_hop")

    def k6_launches(sc, mt, counts, kw):
        """{K6 kernel: launches} that a frame must show. On the "cuda" route
        (path.step_route: every render of the path family on the card)
        path_rr, path_shade and path_resolve max_depth a wave on the batched
        loop (closed, scene-sharded, coated frames), one an iteration on the
        wavefront loop (as many as K8's), max_depth an evaluation of an
        mltpath frame (path_shade and path_bsdf each); path_coat as often
        where the scene has coated materials, else none; BDPT and MLT over
        BDPT none of them; the shading yardstick path_shade_lane never. A
        volumetric frame: of the path family path_rr and the VOLUMETRIC
        variants iterations (2 max_depth + 4) a wave and K6t MAX_HOPS times
        that, the other K6 kernels none; BDPT K6t MAX_HOPS a wave, MLT over
        BDPT MAX_HOPS an evaluation; a frame without media none of K6V."""
        waves = sum(1 for _ in rd.wave_lanes(mt.resolution[0] * mt.resolution[1], mt.spp, "cpu"))
        if mt.volumetric:
            out = dict.fromkeys(K6C + ("path_shade_lane",) + K6V, 0)
            if mt.integrator in bd.PATH_INTEGRATORS:
                n = pth.iterations(mt) * waves
                out.update(path_rr=n, path_shade_vol=n, path_bsdf_vol=n, path_resolve_vol=n,
                           transmit_hop=pth.MAX_HOPS * n)
            elif mt.integrator == "bdpt":
                out.update(transmit_hop=pth.MAX_HOPS * waves)
            else:
                out.update(transmit_hop=pth.MAX_HOPS * mlt_evals["bdpt"])
            return out
        if mt.integrator == "mltpath":
            n = mt.max_depth * mlt_evals["n"]
        elif mt.integrator not in bd.PATH_INTEGRATORS or pth.step_route(dev, mt) != "cuda":
            n = 0
        elif mt.open_scene and sc.shard is None and not kw.get("shard_parts"):
            n = counts.get("wavefront_recycle", 0)
        else:
            n = mt.max_depth * waves
        return dict(dict.fromkeys(K6, n), path_coat=n if mt.layered else 0, path_shade_lane=0,
                    **dict.fromkeys(K6V, 0))

    def full_render(tag, sc, mt, must, **kw):
        """The measured render of a full-width frame, its kernels'
        first-launch arguments kept; K6's launches as k6_launches says."""
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        mlt_evals["n"] = mlt_evals["bdpt"] = 0
        torch.cuda.synchronize()
        t0 = time.time()
        img, stats = render_captured(tag, sc, mt, return_stats=True, **kw)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in read_counts().items() if v}
        main_counts_frame.clear()
        main_counts_frame.update(counts)
        frame_counts[tag], frame_walls[tag] = counts, wall
        img = img.cpu().numpy()
        n_rays = stats["closest"] + stats["shadow"]
        require(img.shape == (mt.resolution[1], mt.resolution[0], 3) and np.isfinite(img).all(),
                tag, "non-finite pixels")
        require(all(counts.get(k, 0) > 0 for k in must), tag, "kernel not launched", counts)
        want_k6 = k6_launches(sc, mt, counts, kw)
        got_k6 = {k: counts.get(k, 0) for k in K6C + ("path_shade_lane",) + K6V}
        require(got_k6 == want_k6, tag, "K6 launches", got_k6, "expected", want_k6)
        # K13 on a textured scene: once a shading launch of the path family
        # (shade_cuda launches it) and once a walk step of BDPT (2 max_depth
        # + 1 a wave, MLT over BDPT an evaluation); never on an untextured one
        steps = 2 * mt.max_depth + 1
        want_tex = (0 if not mt.textured else
                    steps * sum(1 for _ in rd.wave_lanes(mt.resolution[0] * mt.resolution[1],
                                                         mt.spp, "cpu"))
                    if mt.integrator == "bdpt" else steps * mlt_evals["bdpt"]
                    if mt.integrator in ("mlt", "mltbdpt")
                    else want_k6["path_shade"] + want_k6["path_shade_vol"])
        require(counts.get("tex_eval", 0) == want_tex, tag, "K13 launches",
                counts.get("tex_eval", 0), "expected", want_tex)
        for k in must:  # a kernel on several paths: counted on its first
            main_counts.setdefault(k, counts[k])
        out_png = kernels.BUILD_DIR / f"{tag}.png"
        png.write_png(str(out_png), filmlib.to_srgb8(img))
        frame_means[tag] = float(img.mean())
        frame_imgs[tag] = img
        frame_peaks[tag] = torch.cuda.max_memory_allocated() / 2**30
        per = (f"{mt.mutations_per_pixel} mutations/pixel" if mt.integrator in bd.MLT_INTEGRATORS
               else f"{mt.spp} spp {mt.filter_kind}")
        evals = (f"; {mlt_evals['n']} path evaluations" if mlt_evals["n"] else
                 f"; {mlt_evals['bdpt']} BDPT evaluations" if mlt_evals["bdpt"] else "")
        log(f"full render {tag} {mt.integrator} {mt.resolution[0]}^2 x {per} depth "
            f"{mt.max_depth}: {wall:.3f} s wall (first-launch copies included), "
            f"{stats['closest']} closest + {stats['shadow']} shadow rays = "
            f"{n_rays / wall / 1e6:.3f} M rays/s; launches {counts} (K6 {want_k6}, as "
            f"required{evals}); "
            f"mean {img.mean():.5f}; "
            f"all finite; peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
            f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} over the "
            f"{held / 2**30:.2f} held before it) -> {out_png.relative_to(ROOT)}")
        return stats

    def on_route(route, fn):
        """fn() with the path step on `route`: "plain" points it at its plain
        version (path.step_route patched by this script, not a knob of the
        package), "cuda" leaves the route the package chooses."""
        orig = pth.step_route
        if route == "plain":
            pth.step_route = lambda device, meta_, skind=None: "plain"
        try:
            return fn()
        finally:
            pth.step_route = orig

    def loop_frame(sc, mt, loop):
        """One frame through the batched or the wavefront loop, its launch
        counts set to 0 before it -> (image (H, W, 3) numpy, ray counts,
        wall seconds, the launch counts, the frame's peak device GiB over
        what was allocated before it)."""
        film = filmlib.new_film(mt.resolution, dev)
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.time()
        st = (rd.render_batched(sc, mt, film) if loop == "batched"
              else rd.render_wavefront(sc, mt, film)[0])
        img = filmlib.develop(film, mt.resolution, out_matrix=mt.film_out_matrix,
                              imaging_ratio=mt.film_imaging_ratio)
        torch.cuda.synchronize()
        wall = time.time() - t0
        return (img.cpu().numpy(), {k: int(v) for k, v in st.items()}, wall,
                {k: v for k, v in read_counts().items() if v},
                (torch.cuda.max_memory_allocated() - held) / 2**30)

    st_cm = full_render("cornell_mesh", scene, meta, ("bvh_closest_hit", "bvh_any_hit",
                                                      "bvh_refit", "film_add_samples") + K6)
    # the tiled film add has no atomics: the same frame's film twice, the
    # same bits
    films = [filmlib.new_film(meta.resolution, dev) for _ in range(2)]
    for f_ in films:
        rd.render_batched(scene, meta, f_)
    require(torch.equal(films[0].rgb_sum, films[1].rgb_sum)
            and torch.equal(films[0].weight_sum, films[1].weight_sum),
            "cornell-mesh films differ between two renders on the card")
    log("cornell-mesh frame rendered twice on the card through the batched loop: rgb_sum and "
        "weight_sum bit-identical")
    del films
    full_render("cornell", s_corn, m_corn, ("dense_tri_closest", "dense_tri_any",
                                            "dense_spheres", "dense_spheres_any",
                                            "film_add_samples") + K6)
    log(f"cornell: K4 {main_counts_frame['dense_spheres']} closest-hit and "
        f"{main_counts_frame['dense_spheres_any']} any-hit launches")
    t0 = time.time()
    s_terr, m_terr = ts.terrain(res=256, spp=16, device=dev)
    log(f"terrain compile: {time.time() - t0:.2f} s ({m_terr.n_tris} tris, PLY written and "
        f"read, SAH BVH of {s_terr.bvh_rows.shape[0]} rows, depth {m_terr.bvh_depth})")
    require(m_terr.open_scene, "terrain must take the wavefront loop")
    st_w = full_render("terrain", s_terr, m_terr, ("bvh_closest_hit", "bvh_any_hit", "bvh_refit",
                                                   "wavefront_recycle", "film_add_scatter") + K6)
    require("film_add_samples" not in main_counts_frame, "terrain's wavefront frame took the "
            "tiled film add", main_counts_frame)
    t0 = time.time()
    st_terr_b = rd.render_batched(s_terr, m_terr, filmlib.new_film(m_terr.resolution, dev))
    st_terr_b = {k: int(v) for k, v in st_terr_b.items()}
    require(st_w == st_terr_b, "wavefront and batched ray counts differ", st_w, st_terr_b)
    log(f"terrain through the batched loop: {time.time() - t0:.3f} s wall, the same "
        f"{st_terr_b['closest']} + {st_terr_b['shadow']} rays as the wavefront loop (no work item "
        f"dropped or repeated; render() raises on dropped != 0)")
    # the standing of the wavefront loop (K5 scatter, K8) against the
    # batched loop (K5 tiled) on terrain: three frames each, in turns
    t_loops = {"wavefront": [], "batched": []}
    for _ in range(3):
        for name, loop in (("wavefront", rd.render_wavefront), ("batched", rd.render_batched)):
            f_ = filmlib.new_film(m_terr.resolution, dev)
            torch.cuda.synchronize()
            t0 = time.time()
            loop(s_terr, m_terr, f_)
            torch.cuda.synchronize()
            t_loops[name].append(time.time() - t0)
    med = {k: float(np.median(v)) for k, v in t_loops.items()}
    log(f"terrain frame, three each in turns: wavefront loop {t_loops['wavefront']} s (median "
        f"{med['wavefront']:.4f}), batched loop {t_loops['batched']} s (median "
        f"{med['batched']:.4f}); wavefront / batched {med['wavefront'] / med['batched']:.3f}")

    # the disk kernel's path: caustic-glass (path) 48^2 x 4, card vs CPU
    b_c48 = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    b_c48.film["xresolution"] = b_c48.film["yresolution"] = 48
    s_c48, m_c48 = compile_scene(b_c48, 4, device=dev, integrator_override="path")
    reset_counts()
    img_gpu = render_captured("caustic", s_c48, m_c48).cpu().numpy()
    counts = {k: v for k, v in read_counts().items() if v}
    require(counts.get("dense_disks", 0) > 0, "disk kernel not launched", counts)
    main_counts.setdefault("dense_disks", counts["dense_disks"])
    img_cpu = rd.render(s_c48, m_c48, device="cpu").numpy()
    fb_c = check_image(img_gpu, img_cpu, "caustic-glass vs cpu render")
    log(f"caustic-glass (path) 48^2 x 4 spp: launches {counts}; vs cpu {fb_c:.4%} bad px, "
        f"means {img_gpu.mean():.5f} / {img_cpu.mean():.5f}")

    # the coated scenes at their files' settings, each rendered once
    def k7_frame_counts(tag, mt):
        """K7's launches in the frame just rendered: max_depth a wave each of
        layered_f and layered_sample, twice that of layered_pdf (NEE and the
        MIS pdf), and no yardstick."""
        waves = sum(1 for _ in rd.wave_lanes(mt.resolution[0] * mt.resolution[1], mt.spp,
                                             "cpu"))
        want = {"layered_f": waves * mt.max_depth, "layered_sample": waves * mt.max_depth,
                "layered_pdf": 2 * waves * mt.max_depth}
        got = {k: main_counts_frame.get(k, 0) for k in k7 + k7_yard}
        require(got == dict(want, **dict.fromkeys(k7_yard, 0)), tag, "K7 launches",
                got, "expected", want)
        log(f"{tag}: K7 launches as expected {want} ({waves} waves x max depth "
            f"{mt.max_depth}), its yardsticks none")

    t0 = time.time()
    s_st, m_st = load_scene(str(ROOT / "scenes" / "staircase.pbrt"), device=dev)
    log(f"staircase compile: {time.time() - t0:.2f} s ({m_st.n_tris} tris, PLY read, SAH BVH "
        f"of {s_st.bvh_rows.shape[0]} rows, depth {m_st.bvh_depth})")
    require(not m_st.open_scene and m_st.layered, "staircase: closed coated scene")
    full_render("staircase", s_st, m_st, ("bvh_closest_hit", "bvh_any_hit",
                                          "film_add_samples") + k7 + K6C)
    k7_frame_counts("staircase", m_st)
    s_tb, m_tb = load_scene(str(ROOT / "scenes" / "material-testball.pbrt"), device=dev)
    require(m_tb.sph_partial and m_tb.layered, "testball: partial sphere, coated")
    full_render("testball", s_tb, m_tb, ("bvh_closest_hit", "bvh_any_hit", "dense_spheres",
                                         "dense_spheres_any", "film_add_samples") + k7 + K6C)
    log(f"testball: K4 {main_counts_frame['dense_spheres']} closest-hit and "
        f"{main_counts_frame['dense_spheres_any']} any-hit launches (the partial sphere's)")
    k7_frame_counts("testball", m_tb)

    # BDPT at the bench's settings: every kernel of a wave launched exactly
    # as often as the estimator needs; K12 reads the walks' tensors in place,
    # so neither its yardsticks nor the packed copy they read may appear
    k12_yard = ("bdpt_connect_rays_lane", "bdpt_connect_weight_lane")

    @contextlib.contextmanager
    def packing_counted():
        """Count the calls of bdpt.pack_vertices and pack_endpoints within."""
        packed, origs = {"calls": 0}, (bdpt.pack_vertices, bdpt.pack_endpoints)

        def counted(fn):
            def call(*a, **k):
                packed["calls"] += 1
                return fn(*a, **k)
            return call

        bdpt.pack_vertices, bdpt.pack_endpoints = map(counted, origs)
        try:
            yield packed
        finally:
            bdpt.pack_vertices, bdpt.pack_endpoints = origs

    def bdpt_launches(mt):
        """{kernel: launches} of a BDPT frame: per wave K12's two entry
        points, one K5, one K5s, one occluded dispatch for every strategy's
        shadow ray (K3a, K4's any-hit entry and K4a), and max_depth + 1
        camera and max_depth light closest-hit dispatches (K3, K4, K4a)."""
        waves = sum(1 for _ in rd.wave_lanes(mt.resolution[0] * mt.resolution[1], mt.spp,
                                             "cpu"))
        walk = 2 * mt.max_depth + 1
        out = {"bdpt_connect_rays": waves, "bdpt_connect_weight": waves,
               "film_add_samples": waves, "film_add_splats": waves,
               "dense_tri_closest": waves * walk, "dense_tri_any": waves,
               "dense_spheres": waves * walk, "dense_spheres_any": waves}
        if mt.n_disks:
            out["dense_disks"] = waves * (walk + 1)
        return out, waves

    s_cb, m_cb = ts.cornell(res=128, spp=8, device=dev, integrator="bdpt")
    b_cgf = bd.SceneBuilder().parse_file(str(ROOT / "scenes" / "caustic-glass.pbrt"))
    s_cgf, m_cgf = compile_scene(b_cgf, device=dev)
    require((m_cb.max_depth, m_cgf.integrator, m_cgf.max_depth, m_cgf.spp, m_cgf.resolution)
            == (5, "bdpt", 7, 64, (256, 256)), "BDPT frame settings")
    bdpt_got = {}
    for tag, sc, mt in (("cornell_bdpt", s_cb, m_cb), ("caustic_bdpt", s_cgf, m_cgf)):
        want, waves = bdpt_launches(mt)
        with packing_counted() as packed:
            full_render(tag, sc, mt, tuple(want))
        got = {k: main_counts_frame[k] for k in want}
        require(got == want, tag, "launches", got, "expected", want)
        require(not packed["calls"] and not any(main_counts_frame.get(k) for k in k12_yard), tag,
                "K12's yardsticks or their packing on the main path", packed, main_counts_frame)
        bdpt_got[tag] = got
        log(f"{tag}: {waves} wave(s) of {captured[tag]['bdpt_wave'][0][4].shape[0]} lanes, "
            f"launches as expected {want}; K12 read the walks' own tensors (no packed copy "
            f"made, its yardsticks not launched)")
    # the kernels line reports BDPT's kernels as caustic-glass's frame counted them
    for k in ("bdpt_connect_rays", "bdpt_connect_weight", "film_add_splats"):
        main_counts[k] = bdpt_got["caustic_bdpt"][k]

    phase_start("9")
    # ---- 9. each kernel against its plain version and timed, on the
    # arguments of its first main-path launch
    timing = {}

    def first(tag, name):
        a, k, orig = captured[tag][name]
        return a, k, orig

    # K1 and K1a on five launches each: the first of cornell-mesh, terrain
    # and staircase and the third (bounce rays) of cornell-mesh and
    # staircase. On each: against the plain version (phase 3's criteria),
    # the bound from the oracle count of bvh.traversal_work (closest hit:
    # to the plain closest t; any hit: to t_max on the rays the plain
    # version finds unblocked, and on the blocked ones the cheapest root
    # path to a leaf holding a hit, weighed by this file's op counts), timed
    # twice
    k1_scenes = {"cornell_mesh": (scene, meta), "terrain": (s_terr, m_terr),
                 "staircase": (s_st, m_st)}
    for any_hit in (False, True):
        name = "bvh_any_hit" if any_hit else "bvh_closest_hit"
        launches_k1, err_k1 = {}, 0.0
        for tag, nth in (("cornell_mesh", ""), ("terrain", ""), ("staircase", ""),
                         ("cornell_mesh", "#3"), ("staircase", "#3")):
            (rows_t, nint_t, depth_t, o_t, d_t, t_t, *_), _, _ = first(tag, name + nth)
            sc_t, mt_t = k1_scenes[tag]
            R_t = o_t.shape[0]
            if any_hit:
                (occ, ms_plain), err, n_tie = compare_any(o_t, d_t, t_t, sc_t, mt_t), 0.0, 0
                n_live, t_lim = int(occ.sum()), t_t
            else:
                n_live, n_tie, _, _, err, t_lim, ms_plain = compare_closest(o_t, d_t, t_t, sc_t,
                                                                            mt_t)
                occ = None
            err_k1 = max(err_k1, err)
            oracle = bvh.traversal_work(rows_t, nint_t, o_t, d_t, t_lim, occ, (
                SLAB_VISIT_OPS, TRI_EDGE_OPS, TRI_RANGE_OPS, TRI_BOUND_OPS))
            work = torch.zeros(4, dtype=torch.int64, device=dev)
            bvh.traverse_cuda(rows_t, nint_t, depth_t, o_t, d_t, t_t, any_hit, stats=work)
            stats_k = tuple(int(x) for x in work.cpu())
            turns = [graph_ms(lambda: bvh.traverse_cuda(rows_t, nint_t, depth_t, o_t, d_t, t_t,
                                                        any_hit)) for _ in range(2)]
            ms_t = (turns[0] + turns[1]) / 2
            b_t = bound(rows_t.numel() * 4 + R_t * 36,
                        oracle[0] * SLAB_VISIT_OPS + tri_test_ops(*oracle[1:]))
            label = f"{tag}{' third' if nth else ' first'}"
            launches_k1[label] = dict(ms=ms_t, bound_ms=b_t[0], bound_by=b_t[1],
                                      plain_ms=ms_plain, lanes=R_t, live=int((t_t > 0).sum()),
                                      work=oracle, kernel_stats=stats_k)
            log(f"{name} on {label} launch ({R_t} lanes, {int((t_t <= 0).sum())} with t_max <= 0, "
                f"{n_live} {'occluded' if any_hit else 'hits'}; against plain: "
                f"{'equal' if any_hit else f'bit-exact but {n_tie} verified ties'}, plain "
                f"{ms_plain:.1f} ms): K1 {turns[0]:.4f} / {turns[1]:.4f} ms; oracle work (rows, "
                f"tri tests, past edge, past range) {oracle}, bound {b_t[0]:.4f} ms ({b_t[1]}), "
                f"K1 {ms_t / b_t[0]:.1f}x it; the kernel's own stats {stats_k}")
        cm = launches_k1["cornell_mesh first"]
        o_, d_, t_ = first("cornell_mesh", name)[0][3:6]
        call = events_ms(lambda: bvh.traverse_cuda(rows, n_int, depth, o_, d_, t_, any_hit), 20)
        timing[name] = dict(ms=cm["ms"], plain_ms=cm["plain_ms"], bound_ms=cm["bound_ms"],
                            bound_by=cm["bound_by"], library_ms=None, max_abs_err=err_k1,
                            host_paced_ms=call, launches_timed=launches_k1)

    # K5's tiled entry on cornell-mesh's first launch (k replicates of the
    # pixel grid), its scatter entry on terrain's (the wavefront loop)
    tile_c, L_c, lam_c, pdf_c, w_c, k_c = first("cornell_mesh", "film_add_samples")[0][2:]
    n_c = tile_c.shape[0]
    n_l = n_c * k_c
    err = compare_tiled((tile_c, L_c, lam_c, pdf_c, w_c), k_c)
    fk = filmlib.new_film((256, 256), dev)
    ms, call = kernel_ms(lambda: film_kernel.add_samples_tiled_cuda(
        fk.rgb_sum, fk.weight_sum, tile_c, L_c, lam_c, pdf_c, w_c, k_c))
    ms_plain = events_ms(lambda: film_kernel.add_samples_tiled_plain(
        fk.rgb_sum, fk.weight_sum, tile_c, L_c, lam_c, pdf_c, w_c, k_c), 20)
    pix_l = tile_c.repeat(k_c)
    rgb_l, rows4 = torch.rand((n_l, 3), device=dev), torch.rand((n_l, 4), device=dev)
    acc4 = torch.zeros((n_px, 4), device=dev)
    ms_lib = graph_ms(lambda: fk.rgb_sum.index_add_(0, pix_l, rgb_l))
    ms_lib4 = graph_ms(lambda: acc4.index_add_(0, pix_l, rows4))
    ms_sum = graph_ms(lambda: rows4.view(k_c, n_c, 4).sum(0))
    b = bound(n_l * 52 + n_c * (8 + 2 * 16) + 3 * 471 * 4, n_l * FILM_LANE_OPS)
    timing["film_add_samples"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                      library_ms=ms_lib, library_rgbw_ms=ms_lib4,
                                      library_sum_ms=ms_sum, max_abs_err=err)
    log(f"film_add_samples (tiled) at the main path's launch ({k_c} x {n_c} lanes, groups of "
        f"{film_kernel.tile_group(n_c, k_c)}): bit-exact with its plain version; kernel "
        f"{ms:.4f} ms (host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, index_add_ of the "
        f"(R, 3) rgb {ms_lib:.4f} ms, of the (R, 4) (w rgb, w) rows {ms_lib4:.4f} ms, the sum "
        f"over the {k_c} replicates {ms_sum:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")

    pix_t, L_t, lam_t, pdf_t, w_t = first("terrain", "film_add_scatter")[0][2:]
    R_t = pix_t.shape[0]
    err = compare_film((pix_t, L_t, lam_t, pdf_t, w_t))
    live_t = w_t != 0
    n_live, n_touch = int(live_t.sum()), int(pix_t[live_t].unique().numel())
    ms, call = kernel_ms(lambda: film_kernel.add_samples_cuda(fk.rgb_sum, fk.weight_sum, pix_t,
                                                              L_t, lam_t, pdf_t, w_t))
    ms_plain = events_ms(lambda: film_kernel.add_samples_plain(fk.rgb_sum, fk.weight_sum, pix_t,
                                                               L_t, lam_t, pdf_t, w_t), 20)
    rgb_t, rows4_t = torch.rand((R_t, 3), device=dev), torch.rand((R_t, 4), device=dev)
    ms_lib = graph_ms(lambda: fk.rgb_sum.index_add_(0, pix_t, rgb_t))
    ms_lib4 = graph_ms(lambda: acc4.index_add_(0, pix_t, rows4_t))
    # every lane's weight; a live lane's id, L, lambda and pdf; each pixel
    # it touches read and written once
    b = bound(R_t * 4 + n_live * 56 + n_touch * 32 + 3 * 471 * 4, n_live * FILM_LANE_OPS)
    timing["film_add_scatter"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                      library_ms=ms_lib, library_rgbw_ms=ms_lib4,
                                      max_abs_err=max(err, film_err))
    log(f"film_add_scatter at terrain's first launch ({R_t} lanes, {n_live} of weight != 0 "
        f"into {n_touch} pixels): max abs err {err:.2e} against its plain version; kernel "
        f"{ms:.4f} ms (host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, index_add_ of the "
        f"(R, 3) rgb {ms_lib:.4f} ms, of the (R, 4) (w rgb, w) rows {ms_lib4:.4f} ms, bound "
        f"{b[0]:.4f} ms ({b[1]})")

    # K3 and K3a at cornell's and caustic-glass BDPT's first launches, K4
    # (closest and any hit) at cornell's, testball's and caustic-glass
    # BDPT's, K4a at caustic-glass's path frame's (9,216 lanes) and BDPT
    # frame's (2^20): against the plain version, every other launch shape
    # the wrapper can pick bit-equal, an empty launch and the bound
    # (dense_time); caustic-glass-mlt's 8,192-lane launches in phase 10
    dense_empty = dense_empty_ms()

    def dense_check(kind, args):
        """The wrapper against the plain version (phase 5's criteria) ->
        max abs err of t."""
        if kind in ("disks", "spheres"):
            return compare_quadrics(kind, *args)[2]
        if kind == "spheres_any":
            compare_sphere_any(*args)
            return 0.0
        return compare_dense_tris(*args[:3], args[3:6], kind == "any")[1]

    def occluded_rays(tag):
        """The rays of the frame's first occluded dispatch: K3a's first
        launch's (dispatch.occluded runs the sphere and disk sweeps on the
        same shadow rays)."""
        return first(tag, "dense_tri_any")[0][:3]

    for name, kind, shapes in (
            ("dense_spheres", "spheres", (("cornell", "cornell's first launch"),
                                          ("testball", "testball's first launch"),
                                          ("caustic_bdpt",
                                           "caustic-glass BDPT's first walk launch"))),
            ("dense_spheres_any", "spheres_any", (
                ("cornell", "cornell's first occluded dispatch"),
                ("testball", "testball's first occluded dispatch"),
                ("caustic_bdpt", "caustic-glass BDPT's first occluded dispatch"))),
            ("dense_tri_closest", "tris", (("cornell", "cornell's first launch"),
                                           ("caustic_bdpt", "caustic-glass BDPT's first launch"))),
            ("dense_tri_any", "any", (("cornell", "cornell's first launch"),
                                      ("caustic_bdpt", "caustic-glass BDPT's first launch"))),
            ("dense_disks", "disks", (("caustic", "caustic-glass 48^2 x 4's first launch"),
                                      ("caustic_bdpt", "caustic-glass BDPT's first launch"),
                                      ("caustic_bdpt_occluded",
                                       "caustic-glass BDPT's first occluded dispatch")))):
        for tag, label in shapes:
            args = (occluded_rays("caustic_bdpt") + (dispatch._disks(s_cgf, m_cgf),)
                    if tag == "caustic_bdpt_occluded" else first(tag, name)[0])
            err = dense_check(kind, args)
            t_d = dict(dense_time(kind, args, label, empty=dense_empty), max_abs_err=err)
            if name not in timing:
                timing[name] = t_d
            else:
                timing[name][tag] = t_d
                timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"], err)

    # K4 over caustic-glass BDPT's first wave's 2 max_depth + 1 walk launches
    # (live on fewer lanes at each step): each mode's bits equal the
    # wrapper's, the wrapper's graph-timed launches summed
    walk = [first("caustic_bdpt", "dense_spheres" if n == 1 else f"dense_spheres#{n}")[0]
            for n in range(1, 2 * m_cgf.max_depth + 2)]
    walk_ms, live = 0.0, []
    for args in walk:
        ref = ix.dense_spheres_cuda(*args)
        for k, fn in dense_modes("spheres", args).items():
            fn()
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(fn.out, ref)), "spheres walk", k,
                    "differs from the wrapper's outputs")
        walk_ms += graph_ms(lambda: ix.dense_spheres_cuda(*args))
        live.append(float((args[2] > 0).float().mean()))
    timing["dense_spheres"]["caustic_bdpt_walk_sum_ms"] = walk_ms
    log(f"dense_spheres over caustic-glass BDPT's first wave's {len(walk)} walk launches "
        f"({walk[0][0].shape[0]} lanes, live on {', '.join(f'{x:.2f}' for x in live)} of them): "
        f"{walk_ms:.5f} ms summed; every mode's bits equal the wrapper's")
    del walk

    # K8 on terrain's first launch, as the main path calls it (no rank)
    (fin, inf_, cnt, total, *_), _, _ = first("terrain", "wavefront_recycle")
    R_ = fin.shape[0]
    for with_rank in (True, False):
        ck, cp = cnt.clone(), cnt.clone()
        out_k = rd.recycle_cuda(fin, inf_, ck, total, with_rank)
        out_p = rd.recycle_plain(fin, inf_, cp, total, with_rank)
        require(all(a is b is None or torch.equal(a, b) for a, b in zip(out_k, out_p))
                and torch.equal(ck, cp), "recycle differs from cumsum on the main path's launch")
    # the device kernels of one call, from the script's only torch.profiler
    # session (profile_windows), which also holds K6's: one bounce of
    # cornell-mesh's first wave on either route, and the frames of K6's
    # comparison, once on either route (their device time, for the busy
    # share)
    cp = cnt.clone()
    k6_state = first("cornell_mesh", "path_rr")[0][1]
    k6_frames = (("cornell_mesh", scene, meta, "batched"), ("cornell", s_corn, m_corn, "batched"),
                 ("terrain_wavefront", s_terr, m_terr, "wavefront"),
                 ("terrain_batched", s_terr, m_terr, "batched"))
    # the coated frames: testball in turns plain, cuda, cuda, plain;
    # staircase plain, cuda, cuda; their CUDA frames profiled (a profiled
    # plain coated frame, ~6.8k eager kernels a bounce, costs the profiler
    # minutes of this script's time)
    k6_coated_frames = (("testball", s_tb, m_tb, ("plain", "cuda", "cuda", "plain"),
                         ("cuda",)),
                        ("staircase", s_st, m_st, ("plain", "cuda", "cuda"), ("cuda",)))
    k6_state_st = first("staircase", "path_rr")[0][1]
    windows = [("k8", lambda: rd.recycle_cuda(fin, inf_, cp, total, False))]
    for route in ("plain", "cuda"):
        windows.append((f"bounce {route}", lambda route=route: on_route(
            route, lambda: pth.bounce_step(scene, meta, k6_state, meta.sampler, meta.spp))))
        windows.append((f"staircase bounce {route}", lambda route=route: on_route(
            route, lambda: pth.bounce_step(s_st, m_st, k6_state_st, m_st.sampler, m_st.spp))))
    for tag, sc_, mt_, loop in k6_frames:
        for route in ("plain", "cuda"):
            windows.append((f"{tag} {route}", lambda sc_=sc_, mt_=mt_, loop=loop, route=route:
                            on_route(route, lambda: loop_frame(sc_, mt_, loop))))
    for tag, sc_, mt_, _, profiled in k6_coated_frames:
        for route in profiled:
            windows.append((f"{tag} {route}", lambda sc_=sc_, mt_=mt_, route=route:
                            on_route(route, lambda: loop_frame(sc_, mt_, "batched"))))
    k6_prof = profile_windows(windows)
    names = k6_prof["k8"][3]
    require(k6_prof["k8"][:2] == (1, 0) and "recycle_kernel" in names[0], "K8 is not one launch",
            k6_prof["k8"])
    # timed on one counters tensor, which the calls advance in place (the
    # kernel's work does not depend on it); with_clone_ms adds a clone of the
    # counters a call (a 16-byte device copy), as this script timed the
    # two-launch kernel before it
    ct = cnt.clone()
    ms, call = kernel_ms(lambda: rd.recycle_cuda(fin, inf_, ct, total, False))
    ms_rank = graph_ms(lambda: rd.recycle_cuda(fin, inf_, ct, total))
    ms_clone = graph_ms(lambda: rd.recycle_cuda(fin, inf_, cnt.clone(), total, False))
    ms_plain = events_ms(lambda: rd.recycle_plain(fin, inf_, cnt.clone(), total, False), 20)
    fin_i = fin.to(torch.int32)
    ms_lib = graph_ms(lambda: torch.cumsum(fin_i, 0, dtype=torch.int32))
    # 2 bytes in and 10 out a lane (work, two masks), the two counters
    b = bound(R_ * 2 + R_ * 10 + 16, 2 * R_)
    b_rank = bound(R_ * 16 + 16, 2 * R_)
    timing["wavefront_recycle"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                       library_ms=ms_lib, with_rank_ms=ms_rank,
                                       with_clone_ms=ms_clone,
                                       with_rank_bound_ms=b_rank[0], max_abs_err=0.0)
    log(f"wavefront_recycle at the main path's launch ({R_} lanes, {int(fin.sum())} finished, "
        f"work {int(cnt[0])} of {total}): bit-exact with and without the rank, one device "
        f"kernel; kernel {ms:.4f} ms without the rank (host-paced {call:.4f} ms), "
        f"{ms_rank:.4f} ms with it, {ms_clone:.4f} ms with a clone of the counters a call, plain {ms_plain:.3f} ms, torch.cumsum {ms_lib:.4f} ms, "
        f"bound {b[0]:.5f} ms ({b[1]}; with the rank {b_rank[0]:.5f} ms)")

    log(f"[K6 checks start at {time.time() - t_start:.1f} s]")
    # ---- K6: the path step's four kernels (csrc/path_step.cu) against
    # their plain parts, each on the plain chain's inputs (tests/
    # path_cases.py's criteria): on path_cases' synthetic lanes of the
    # four-light scene (both samplers, 2^18 lanes and 1,000), of its coated
    # variant and with the MLT kind, and on the first and third bounces of
    # the cornell-mesh, cornell, terrain, staircase and testball frames
    # (path_coat on identical inputs; the whole coated bounce on the lane
    # means of its coated lanes); each timed on cornell-mesh's first bounce
    # (path_coat on staircase's) beside its bound and its plain part, and on
    # staircase's; the device kernels of one bounce on either route (the
    # profiled windows above); then the frames of cornell-mesh, cornell,
    # terrain (both loops), testball and staircase with the step pointed at
    # its plain version by this script, in turns
    k6_parts = {"path_rr": (pth.rr_cuda, pth.rr_plain, path_cases.compare_rr),
                "path_shade": (pth.shade_cuda, pth.shade_plain, path_cases.compare_shade),
                "path_coat": (pth.coat_cuda, pth.coat_plain, path_cases.compare_coat),
                "path_resolve": (pth.resolve_cuda, pth.resolve_plain,
                                 path_cases.compare_resolve)}
    k6_err = dict.fromkeys(K6C, 0.0)
    # the fields whose largest error each kernel's line reports (else L)
    K6_ERR_FIELDS = {"path_coat": ("beta", "ld"), "path_bsdf": ("beta",)}

    def k6_check(label, reps):
        for name, rep_ in reps.items():
            require(rep_.ok(), "K6", name, label, str(rep_))
            name = {"path_shade.light": "path_shade", "path_shade.bsdf": "path_bsdf",
                    "path_shade": None}.get(name, name)
            if name in k6_err:
                k6_err[name] = max(k6_err[name], *(rep_.max_abs.get(f, 0.0) for f in
                                                   K6_ERR_FIELDS.get(name, ("L",))))
        log(f"K6 against its plain parts on {label}: "
            + "; ".join(f"{n} {r}" for n, r in reps.items()))

    kernel_parts = tuple(v[0] for v in k6_parts.values())
    plain_parts = tuple(v[1] for v in k6_parts.values())
    # path_shade and path_bsdf, each alone against its part of shade_plain
    shade_split = path_cases.shade_parts()
    for skind, coated, mlt_d in (("independent", False, None), ("stratified", False, None),
                                 ("independent", True, None), ("mlt", False, 6),
                                 ("mlt", True, 30)):
        spp_pc = 0 if skind == "mlt" else 4
        s_pc, m_pc = compile_scene(path_cases.builder(
            24, "stratified" if skind == "stratified" else "independent", 4, coated=coated),
            device=dev)
        for n_l in (1 << 18, 1000):
            st_pc = path_cases.synthetic_state(s_pc, m_pc, n_l, 5, mlt_d=mlt_d)
            reps, seen = path_cases.compare_parts(s_pc, m_pc, st_pc, skind, spp_pc,
                                                  kernel_parts, plain_parts, shade_split)
            label = (f"path_cases' synthetic lanes ({skind}{f' D {mlt_d}' if mlt_d else ''}"
                     f"{', coated scene' if coated else ''}, {seen})")
            if coated or mlt_d:
                rep_b, _ = path_cases.compare_bounce(s_pc, m_pc, st_pc, skind, spp_pc,
                                                     kernel_parts, plain_parts)
                reps = {f"path_{k}": v for k, v in reps.items()} | {"whole bounce": rep_b}
            else:
                reps = {f"path_{k}": v for k, v in reps.items()}
            k6_check(label, reps)
    k6_scenes = {"staircase": (s_st, m_st), "testball": (s_tb, m_tb)}
    shade_yard = {}
    for tag in ("cornell_mesh", "cornell", "terrain", "staircase", "testball"):
        for nth, which in (("", "first"), ("#3", "third")):
            reps = {name: cmp(first(tag, name + nth)[0], kern, plain)
                    for name, (kern, plain, cmp) in k6_parts.items()
                    if name + nth in captured[tag]}
            args_ = first(tag, "path_shade" + nth)[0]
            for part, (kern, plain) in zip(("light", "bsdf"), shade_split):
                reps[f"path_shade.{part}"] = path_cases.compare_shade(args_, kern, plain, part)
            # path_shade and path_bsdf against their yardstick's bits
            bits = path_cases.shade_bits(pth.shade_cuda(*args_), pth.shade_lane_cuda(*args_))
            require(all(v == 1.0 for v in bits.values()), tag, which, "path_shade and path_bsdf "
                    "differ from the yardstick path_shade_lane",
                    {k: v for k, v in bits.items() if v != 1.0})
            shade_yard[f"{tag} {which}"] = len(bits)
            if tag in k6_scenes:
                # the whole coated bounce from the captured input state
                sc_, mt_ = k6_scenes[tag]
                rep_b, n_coat = path_cases.compare_bounce(
                    sc_, mt_, first(tag, "path_rr" + nth)[0][1], mt_.sampler, mt_.spp,
                    kernel_parts, plain_parts)
                reps["whole bounce"] = rep_b
            k6_check(f"{tag}'s {which} bounce ({first(tag, 'path_rr' + nth)[0][1].o.shape[0]} "
                     f"lanes{f', {n_coat} coated' if tag in k6_scenes else ''})", reps)

    log(f"path_shade and path_bsdf against their yardstick path_shade_lane (shading as first "
        f"written) on the first and third bounces of {sorted(shade_yard)}: every output of "
        f"every lane the same bits ({max(shade_yard.values())} fields)")

    def k6_work(name, args_):
        """(bytes, float ops, what was counted) of one K6 launch: each input
        read once by the lanes that read it, each output written once."""
        if name == "path_rr":
            meta_, st, skind_, _ = args_
            R = st.o.shape[0]
            due = st.active & (st.depth < meta_.max_depth) & (st.depth >= st.rr_next)
            n_due = int(due.sum())
            smp_b = 24 + (16 if skind_ == "stratified" else 0)
            return (R * (25 + 41) + n_due * smp_b + 16, n_due * K6_OPS["rr"],
                    f"{n_due} due for RR")
        if name.startswith("path_shade") or name == "path_bsdf":
            # the function (path_shade and path_bsdf together; "path_shade"
            # and "path_bsdf" alone: the inputs only path_bsdf reads (the
            # sampler's state and dimension on every lane, its stream on the
            # shading lanes) and the outputs it writes (BSDF_FIELDS, the
            # coated lanes' uc and u2) are its share, the rest path_shade's:
            # the two shares sum to the function's)
            sc_, meta_, st, hit, skind_, _ = args_[:6]
            R = st.o.shape[0]
            hits = st.active & hit.valid
            shade = hits & (hit.mat >= 0)
            emit = hits & (hit.light >= 0)
            esc = (st.active & ~hit.valid) if meta_.open_scene else torch.zeros_like(hits)
            coat = shade & (sc_.mat_type[hit.mat.clamp(min=0)] >= bd.MAT_COATED_DIFFUSE) & (
                sc_.mat_type[hit.mat.clamp(min=0)] <= bd.MAT_COATED_CONDUCTOR)
            tab = pth.step_tables(sc_)
            n_h, n_s, n_e, n_x, n_c = (int(x.sum()) for x in (hits, shade, emit, esc, coat))
            rows = sum(tab[k].numel() * 4 for k in ("mat", "lt", "spec", "emission", "uinf",
                                                     "scal"))
            rows += 36 * int((sc_.lt_tri >= 0).sum()) + 16 * int((sc_.lt_sph >= 0).sum()) \
                + 32 * int((sc_.lt_dsk >= 0).sum())
            smp_b = 8 + (16 if skind_ == "stratified" else 0)
            # a coated lane writes its layer (two interfaces of 80 bytes,
            # thickness, g, albedo: 184), wo, the light's wi, uc, u2 and the
            # light sample (58); every lane of a coated scene its two masks
            coat_b = (n_c * (184 + 58) + 2 * R) if meta_.layered else 0
            work = f"{n_s} shading, {n_e} emitter hits, {n_x} escaped, {n_c} coated"
            ops_b = n_s * K6_OPS["shade_bsdf"]
            ops = (n_s * K6_OPS["shade"] + n_e * K6_OPS["emit"] + n_x * K6_OPS["escape"]
                   + n_c * K6_OPS["layer"])
            # path_bsdf: the sampler state and dimension in (16) and the
            # next state's o, d, beta, sampler state and dimension, flags
            # and pdf out (62) on every lane, the stream on shading lanes, a
            # coated lane's uc and u2 (12)
            bsdf_b = R * (16 + 62) + n_s * smp_b + (n_c * 12 if meta_.layered else 0)
            whole = R * (139 + 167) + n_h * 52 + n_s * smp_b + rows + coat_b
            if name == "path_shade_pair":
                return whole, ops, work
            if name == "path_bsdf":
                return bsdf_b, ops_b, work
            return whole - bsdf_b, ops - ops_b, work
        if name == "path_coat":
            sc_, st, pend, lanes_, f_, pdf_, smp_ = args_
            R = st.o.shape[0]
            n_c, n_n = int(lanes_.mask.sum()), int(lanes_.nee.sum())
            n_go = int((lanes_.mask & smp_.valid & (smp_.f > 0).any(-1)).sum())
            # every lane: its two masks in, its MIS mask out; a coated lane
            # its hit (36), beta (16) and the layered sample (41) in; an NEE
            # lane the light's direction, radiance, pdf and flags (34) and
            # K7's f and pdf (20) in, its term (16) out; a lane that goes on
            # its ray, beta, flags and MIS direction (54) out
            return (R * 3 + n_c * (36 + 16 + 41) + n_n * (34 + 20 + 16) + n_go * 54,
                    n_c * K6_OPS["coat"], f"{n_c} coated, {n_n} with NEE, ~{n_go} go on")
        st, pending, occ, mis = args_
        R, n_nee = st.L.shape[0], int(pending.mask.sum())
        mis_b = 0 if mis is None else R * 9 + int(mis[0].sum()) * 4
        return (R * 33 + n_nee * 33 + 16 + mis_b, n_nee * K6_OPS["resolve"],
                f"{n_nee} with NEE" + ("" if mis is None else f", {int(mis[0].sum())} MIS pdfs"))

    # the refit of K1's winners (the hit record's glue, one kernel) on
    # cornell-mesh's first closest-hit launch: bit-exact with its plain
    # version, timed beside its bound
    args_ = first("cornell_mesh", "bvh_refit")[0]
    out_k, out_p = bvh.refit_cuda(*args_), bvh.refit_plain(*args_)
    require(all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                            b.view(torch.int32) if b.dtype == torch.float32 else b)
                for a, b in zip(out_k, out_p)), "bvh_refit differs from its plain version")
    ms, call = kernel_ms(lambda: bvh.refit_cuda(*args_))
    ms_plain = events_ms(lambda: bvh.refit_plain(*args_), 3)
    # a lane's ray, t_max and winner in, its t, winner and barycentrics out;
    # the triangle table read once
    R_, n_won = args_[3].shape[0], int((args_[6] >= 0).sum())
    b = bound(R_ * (28 + 8 + 24) + args_[0].shape[0] * 36,
              n_won * (TRI_FULL_OPS + TRI_BARY_OPS))
    timing["bvh_refit"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                               library_ms=None, max_abs_err=0.0, host_paced_ms=call)
    log(f"bvh_refit at cornell-mesh's first closest-hit launch ({R_} lanes, {n_won} winners, "
        f"{int((out_k[1] >= 0).sum())} refit hits): bit-exact with its plain version; kernel "
        f"{ms:.4f} ms (host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, bound {b[0]:.5f} ms "
        f"({b[1]})")

    def k6_timed(tag, name, kern, plain):
        """K6 kernel `name` at the frame's first bounce: graph-timed, its
        plain part with CUDA events, its bound -> the timing record. coat's
        arguments are copied once: its in-place update is the same on every
        call; path_bsdf's are path_shade's."""
        args_ = first(tag, "path_shade" if name == "path_bsdf" else name)[0]
        if name == "path_coat":
            args_ = (args_[0], path_cases.clone(args_[1]), path_cases.clone(args_[2])) + args_[3:]
        ms, call = kernel_ms(lambda: kern(*args_))
        ms_plain = events_ms(lambda: plain(*args_), 3)
        n_bytes, n_ops, work = k6_work(name, args_)
        b = bound(n_bytes, n_ops)
        n_lanes = first(tag, "path_rr")[0][1].L.shape[0]
        log(f"{name} at {tag}'s first bounce ({n_lanes} lanes, {work}): kernel "
            f"{ms:.4f} ms (host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, bound "
            f"{b[0]:.5f} ms ({b[1]}: {n_bytes} bytes, {n_ops} ops), {ms / b[0]:.1f}x it; max abs "
            f"err of {K6_ERR_FIELDS.get(name, ('L',))} over the comparisons "
            f"{k6_err[name]:.3e}")
        return dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], library_ms=None,
                    max_abs_err=k6_err[name], host_paced_ms=call, bytes=n_bytes, ops=n_ops)

    def shade_turns(key, tag):
        """path_shade and path_bsdf (shade_cuda) graph-timed twice on the
        shading launch `key` of frame `tag` -> (kernels ms, the two times).
        Their yardstick path_shade_lane is held to its bits above and not
        timed: PERF.md records the two in turns."""
        args_ = first(tag, key)[0]
        turns = [graph_ms(lambda: pth.shade_cuda(*args_)) for _ in range(2)]
        return (turns[0] + turns[1]) / 2, turns

    timed_parts = dict(k6_parts, path_shade=(shade_split[0][0], shade_split[0][1], None),
                       path_bsdf=(shade_split[1][0], shade_split[1][1], None))
    for name, (kern, plain, _) in timed_parts.items():
        if name == "path_coat":
            timing[name] = k6_timed("staircase", name, kern, plain)
        else:
            timing[name] = k6_timed("cornell_mesh", name, kern, plain)
            timing[name]["staircase"] = k6_timed("staircase", name, kern, plain)
    # the two shading kernels together against their yardstick, beside the
    # function's bound, at the first bounces of cornell-mesh and staircase
    # (targets: <= 0.21 and <= 0.28 ms), then over staircase's first wave
    # (every bounce), times its waves: the replayed frame's total
    for tag, target in (("cornell_mesh", 0.21), ("staircase", 0.28)):
        ms_k, turns = shade_turns("path_shade", tag)
        n_bytes, n_ops, work = k6_work("path_shade_pair", first(tag, "path_shade")[0])
        b = bound(n_bytes, n_ops)
        timing["path_shade"][f"{tag} pair"] = dict(
            ms=ms_k, turns=turns, bound_ms=b[0], bound_by=b[1],
            bytes=n_bytes, ops=n_ops, share_of_bound=b[0] / ms_k, target_ms=target)
        log(f"path_shade + path_bsdf at {tag}'s first bounce ({work}): {turns[0]:.4f} / "
            f"{turns[1]:.4f} ms; the function's bound {b[0]:.5f} ms ({b[1]}: "
            f"{n_bytes} bytes), {b[0] / ms_k:.1%} of it reached; "
            f"target <= {target} ms: {'met' if ms_k <= target else 'missed'}")
    waves_st = sum(1 for _ in rd.wave_lanes(m_st.resolution[0] * m_st.resolution[1], m_st.spp,
                                            "cpu"))
    replay = {"kernels": 0.0}
    for n in range(1, m_st.max_depth + 1):
        replay["kernels"] += shade_turns("path_shade" if n == 1 else f"path_shade#{n}",
                                         "staircase")[0]
    timing["path_shade"]["staircase_frame_replayed"] = {
        k: v * waves_st for k, v in replay.items()}
    log(f"path_shade + path_bsdf over staircase's first wave ({m_st.max_depth} bounces): "
        f"{replay['kernels']:.3f} ms; x{waves_st} waves: a frame's "
        f"{waves_st * m_st.max_depth} launches of each {replay['kernels'] * waves_st:.2f} ms")
    for tag, label in (("bounce", "cornell-mesh's first wave"),
                       ("staircase bounce", "staircase's first wave")):
        kb = {r: k6_prof[f"{tag} {r}"] for r in ("plain", "cuda")}
        require(20 * (kb["cuda"][0] + kb["cuda"][1]) <= kb["plain"][0] + kb["plain"][1],
                "K6: device kernels a bounce not 20x fewer than the plain step's", label,
                kb["plain"][:3], kb["cuda"][:3], kb["cuda"][3])
        timing["path_shade"][f"{tag} kernels"] = {r: kb[r][0] + kb[r][1] for r in kb}
        log(f"device kernels of one bounce of {label} (torch.profiler): plain step "
            f"{kb['plain'][0]} kernels + {kb['plain'][1]} memsets/copies ({kb['plain'][2]:.3f} "
            f"ms device), CUDA step {kb['cuda'][0]} + {kb['cuda'][1]} ({kb['cuda'][2]:.3f} ms), "
            f"{(kb['plain'][0] + kb['plain'][1]) / max(kb['cuda'][0] + kb['cuda'][1], 1):.1f}x "
            f"fewer; the CUDA step's hand-written kernels: "
            f"{sorted({n for n in kb['cuda'][3] if 'at::native' not in n})}, and "
            f"{sum('at::native' in n for n in kb['cuda'][3])} launches of PyTorch's kernels (the "
            f"dispatches' glue)")
    k6_frames_out = {}
    frame_runs = [(tag, sc_, mt_, loop, ("plain", "cuda", "cuda", "plain"), ("plain", "cuda"))
                  for tag, sc_, mt_, loop in k6_frames]
    frame_runs += [(tag, sc_, mt_, "batched", turns, prof)
                   for tag, sc_, mt_, turns, prof in k6_coated_frames]
    for tag, sc_, mt_, loop, turns, profiled in frame_runs:
        runs = {"plain": [], "cuda": []}
        for route in turns:
            runs[route].append(on_route(route, lambda: loop_frame(sc_, mt_, loop)))
        (img_p, st_p, _, c_p, _), (img_c, st_c, _, c_c, _) = runs["plain"][0], runs["cuda"][0]
        n_p, n_c = sum(st_p.values()), sum(st_c.values())
        want_c = dict(dict.fromkeys(K6, 1), path_coat=int(mt_.layered))
        require(not any(c_p.get(k) for k in K6C)
                and all(bool(c_c.get(k)) == bool(v) for k, v in want_c.items()), tag,
                "K6 launches by route", c_p, c_c)
        if mt_.layered:
            # R7: the coated walks are independent estimates where the local
            # directions' bits differ: ray counts within 1 %, 8x8 block means
            require(abs(n_c - n_p) <= 1e-2 * n_p, tag, "ray counts by route", st_p, st_c)
            fb = check_image(blocks(img_c, 8), blocks(img_p, 8),
                             f"{tag}: the CUDA step's frame against the plain step's (8x8 "
                             f"block means)")
        else:
            require(abs(n_c - n_p) <= 1e-3 * n_p, tag, "ray counts by route", st_p, st_c)
            fb = check_image(img_c, img_p, f"{tag}: the CUDA step's frame against the plain "
                             f"step's")
        walls = {r: [x[2] for x in v] for r, v in runs.items()}
        peaks = {r: max(x[4] for x in v) for r, v in runs.items()}
        med = {r: float(np.median(w)) for r, w in walls.items()}
        prof_ = {r: k6_prof[f"{tag} {r}"] for r in profiled}
        k6_frames_out[tag] = dict(
            walls=walls, median=med, rays={"plain": n_p, "cuda": n_c},
            rays_per_s={r: (n_p if r == "plain" else n_c) / med[r] for r in runs},
            busy={r: prof_[r][2] / 1e3 / med[r] for r in prof_},
            device_kernels={r: prof_[r][0] + prof_[r][1] for r in prof_},
            device_ms={r: prof_[r][2] for r in prof_}, launches_k6=c_c, bad=fb,
            peak_gib=peaks)
        o_ = k6_frames_out[tag]

        def by_route(d, fmt):
            return " / ".join(fmt(d[r]) if r in d else "not profiled" for r in ("plain", "cuda"))
        log(f"{tag} frame ({loop} loop), in turns {', '.join(turns)}: walls {walls} s, "
            f"medians plain {med['plain']:.4f} / cuda {med['cuda']:.4f} s "
            f"({med['plain'] / med['cuda']:.2f}x); rays {n_p} / {n_c} "
            f"({n_c / n_p - 1:+.4%}), {o_['rays_per_s']['plain'] / 1e6:.3f} / "
            f"{o_['rays_per_s']['cuda'] / 1e6:.3f} M rays/s; busy "
            f"{by_route(o_['busy'], lambda v: f'{v:.1%}')} (device time of a profiled frame, "
            f"{by_route(o_['device_ms'], lambda v: f'{v:.1f}')} ms, over the median wall); "
            f"device kernels a frame {by_route(o_['device_kernels'], str)}; peak memory "
            f"{peaks['plain']:.3f} / {peaks['cuda']:.3f} GiB over what was held; the CUDA "
            f"frame's launches {c_c}; "
            f"image against the plain frame's {fb:.4%} bad "
            f"{'8x8 blocks' if mt_.layered else 'px'}, means {img_p.mean():.5f} / "
            f"{img_c.mean():.5f}")
    tw = k6_frames_out["terrain_wavefront"]["median"]
    tb = k6_frames_out["terrain_batched"]["median"]
    log(f"K8 condition on terrain: wavefront / batched frame {tw['cuda'] / tb['cuda']:.3f} with "
        f"the CUDA step ({tw['cuda']:.4f} / {tb['cuda']:.4f} s), {tw['plain'] / tb['plain']:.3f} "
        f"with the plain one ({tw['plain']:.4f} / {tb['plain']:.4f} s)")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k6_frames.json").write_text(json.dumps(k6_frames_out, indent=1))

    # K7 on its first launches in the coated frames: against the plain
    # version on the coated lanes of both, against their yardsticks' bits
    # and step counts, and timed on both launches (layered_sample: the share of coated lanes whose sample
    # reflects at the coat, which its set-up pass writes at once); the
    # kernels line takes staircase's (2^20 lanes); then layered_sample over
    # staircase's first wave, times its waves
    for name in ("layered_f", "layered_sample", "layered_pdf"):
        cuda_fn = getattr(layered, f"{name}_cuda")
        plain_fn = getattr(layered, f"{name}_plain")
        launches_k7 = {}
        for tag in ("testball", "staircase"):
            (p_, *args_, mask_), _, _ = first(tag, name)
            res = compare_layered(name, p_, args_, mask_)
            log(f"{name} vs plain on {tag}'s first launch ({args_[0].shape[0]} lanes, the "
                f"coated ones compared): {agreement(res)}")
            n_steps = k7_yardstick(name, p_, args_, mask_, tag)
            ms_k, turns = k7_turns(name, p_, args_, mask_)
            launches_k7[tag] = dict(ms=ms_k, turns=turns, lanes=mask_.numel(),
                                    coated=int(mask_.sum()), steps=n_steps)
            at_once = ""
            if name == "layered_sample":
                walks = layered.layered_sample_setup_plain(p_, *args_)[0][mask_]
                launches_k7[tag]["reflect_at_once"] = share = 1 - float(walks.double().mean())
                at_once = (f"; {share:.2%} of the coated lanes' samples reflect at the coat (the "
                           f"set-up pass writes them), {int(walks.sum())} walk")
            log(f"{name} on {tag}'s first launch: the yardstick's bits and step counts "
                f"({n_steps}); kernel {turns[0]:.4f} / {turns[1]:.4f} ms{at_once}")
        R_, n_live = args_[0].shape[0], int(mask_.sum())
        steps = torch.zeros(1, dtype=torch.int64, device=dev)
        cuda_fn(p_, *args_, mask_, steps)
        n_steps = int(steps.item())
        ms = launches_k7["staircase"]["ms"]
        call = events_ms(lambda: cuda_fn(p_, *args_, mask_), 50)
        ms_plain = events_ms(lambda: plain_fn(p_, *args_), 1)
        n_bytes, read = k7_bytes(name, p_, args_, mask_)
        lane_ops, step_ops = LAYERED_OPS[name]
        if name == "layered_pdf":
            n_same = int((mask_ & (args_[0][:, 2] * args_[1][:, 2] > 0)).sum())
            n_ops = n_same * lane_ops + n_steps * step_ops
            work = f"{read}, {n_steps} reached the base"
        else:
            n_ops = n_live * lane_ops + n_steps * step_ops
            work = f"{read}, {n_steps} walk steps"
        b = bound(n_bytes, n_ops)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=max(res["max_abs_err"],
                                                             layered_err[name]))
        timing[name].update(host_paced_ms=call, launches_timed=launches_k7,
                            synthetic={k: v for k, v in k7_synthetic.items()
                                       if k.startswith(name + " ")})
        log(f"{name} at the main path's launch (staircase, {R_} lanes, {n_live} coated, "
            f"{work}): kernel {ms:.4f} ms (host-paced {call:.4f} ms), "
            f"plain {ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}: {n_bytes} bytes), "
            f"{b[0] / ms:.1%} of it reached"
            + (" (target <= 0.065 ms: " + ("met)" if ms <= 0.065 else "missed)")
               if name == "layered_sample" else ""))
    replay = {"kernel": 0.0}
    for n in range(1, m_st.max_depth + 1):
        (p_, *args_, mask_), _, _ = first("staircase", "layered_sample" if n == 1
                                          else f"layered_sample#{n}")
        k7_yardstick("layered_sample", p_, args_, mask_, f"staircase's bounce {n}")
        replay["kernel"] += k7_turns("layered_sample", p_, args_, mask_)[0]
    timing["layered_sample"]["staircase_frame_replayed"] = {
        k: v * waves_st for k, v in replay.items()}
    log(f"layered_sample over staircase's first wave ({m_st.max_depth} launches, each the "
        f"yardstick's bits): {replay['kernel']:.3f} ms; x{waves_st} waves: a frame's "
        f"{waves_st * m_st.max_depth} launches {replay['kernel'] * waves_st:.2f} ms (target <= "
        f"13 ms: {'met' if replay['kernel'] * waves_st <= 13 else 'missed'})")

    # K12 on the first waves of the BDPT frames, on a 24^2 x 2 wave of the
    # four-light scene (lens; distant, spot and uniform infinite lights,
    # escaped camera rays, the delta-light rule) and on cornell waves at max
    # depth 8 (19 vertex slots: bdpt_connect_weight stages one buffer) and 17
    # (37 slots: it reads them in place): against its plain version,
    # and both entry points against their yardsticks' bits (the
    # one-thread-per-lane kernels over the packed copy, as first written);
    # then timed on caustic-glass's (graph replays of 5 calls: each call allocates its outputs, ~1 GB of shadow
    # rays and 0.7 GB of per-strategy L at 2^20 lanes). Phase 10 does the
    # same at the MLT frame's 8192 lanes.
    s_fl, m_fl = compile_scene(bdpt_cases.four_lights_builder(24), 2, device=dev,
                               integrator_override="bdpt")
    pix_fl = torch.arange(24 * 24, device=dev).repeat(2)
    smp_fl = torch.arange(2, device=dev).repeat_interleave(24 * 24)
    waves_b = {"four_lights": (s_fl, m_fl) + bdpt_cases.wave_inputs(s_fl, m_fl, pix_fl, smp_fl)}
    for depth in (8, 17):
        b_d = ts.cornell_builder(24, "box")
        b_d.integrator["maxdepth"] = depth
        s_d, m_d = compile_scene(b_d, 2, device=dev, integrator_override="bdpt")
        waves_b[f"cornell_depth{depth}"] = (s_d, m_d) + bdpt_cases.wave_inputs(
            s_d, m_d, pix_fl, smp_fl)
    for tag in ("cornell_bdpt", "caustic_bdpt"):
        waves_b[tag] = first(tag, "bdpt_wave")[0]
    k12_err = 0.0

    def k12_check(tag, wave):
        """K12 on one wave against its plain version and its yardsticks."""
        res = bdpt_cases.compare(*wave)
        bdpt_cases.require_agreement(res)
        same = bdpt_cases.compare_yardstick(*wave)
        require(all(same.values()), tag, "K12 against its yardsticks' bits", same)
        log(f"K12 on {tag}'s wave ({res['lanes']} lanes x {res['strategies']} strategies, "
            f"{res['strategies_live']} live on some lane, {res['live']} live contributions): "
            f"the same bits as its yardsticks {same}; against plain, worst strategy "
            f"{res['worst']} agrees on {res['frac']:.6%} of its live lanes within rtol "
            f"{bdpt_cases.RTOL:g}, atol {bdpt_cases.ATOL:g} (>= {bdpt_cases.CLOSE_FRAC:.2%} "
            f"required of every strategy), L {res['L_frac']:.6%}; rays {res['rays_kernel']} = "
            f"plain {res['rays_plain']}; splat pixels differing {res['splat_pix_differ']}; max "
            f"abs err over all contributions {res['max_abs_err']:.3e}")
        return res["max_abs_err"]

    def k12_times(label, wave, a_rays, a_wt, calls):
        """Both K12 entries at one main-path launch, graph-timed twice, beside
        the plain version and the bound (each 4-byte vertex field and
        endpoint field read once, as the packed copy holds them, whatever
        layout the kernel reads); then one wave's peak memory, logged ->
        {name: timing}. The yardsticks are held to their bits (k12_check)
        and not timed: PERF.md records the two in turns."""
        scene_, meta_, light_vs, cam_vs, lam_, table_, samples_ = wave
        _, ft, st = a_rays[:3]
        R_, n_slots = ft.R, len(ft.vertex)
        occ = a_wt[4]
        in_b = (n_slots * bdpt.NF + len(ft.ends) * bdpt.NSF) * R_ * 4 + len(st.rows) * 5 * 4
        media = pth.has_media(scene_)
        seg_plain = bdpt.connect_segments_plain if media else bdpt.connect_rays_plain
        plain_rays = lambda: seg_plain(scene_, light_vs, cam_vs, table_, samples_)
        conns = plain_rays()[0]
        plain_wt = lambda: bdpt.connect_weight_plain(scene_, meta_, light_vs, cam_vs, lam_,
                                                     table_, samples_, conns, occ)
        rays_fn = bdpt.connect_segments_cuda if media else bdpt.connect_rays_cuda
        n_con, out = st.n_ray, {}
        vis_b = n_con * R_ * (16 if media else 1)
        for name, fn, plain, out_b, extra_in, n_s in (
                ("bdpt_connect_rays", lambda: rays_fn(*a_rays), plain_rays,
                 n_con * R_ * (48 if media else 28) + 8, 0, n_con),
                ("bdpt_connect_weight", lambda: bdpt.connect_weight_cuda(*a_wt), plain_wt,
                 R_ * 16 + st.n_t1 * R_ * 24, R_ * 16 + vis_b + 471 * 4 * (
                     1 + scene_.lt_type.shape[0]), len(table_))):
            turns = [graph_ms(fn, calls=calls) for _ in range(2)]
            ms = (turns[0] + turns[1]) / 2
            ms_plain = events_ms(plain, 1)
            b = bound(in_b + extra_in + out_b, R_ * n_s * K12_OPS[name])
            out[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], lanes=R_)
            log(f"{name} at {label} ({R_} lanes, {n_slots} vertex slots, {n_s} strategies): "
                f"kernel {turns[0]:.4f} / {turns[1]:.4f} ms; plain "
                f"{ms_plain:.1f} ms, bound {b[0]:.4f} ms ({b[1]}; "
                f"{(in_b + extra_in + out_b) / 1e9:.3f} GB), kernel {ms / b[0]:.2f}x it")
        # one wave's connections' peak memory (over what is held before them)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        bdpt.connect_all_cuda(scene_, meta_, light_vs, cam_vs, lam_, table_, samples_)
        torch.cuda.synchronize()
        log(f"K12 at {label}: one wave's connections peak at "
            f"{(torch.cuda.max_memory_allocated() - held) / 2**30:.3f} GiB")
        return out

    for tag, wave in waves_b.items():
        k12_err = max(k12_err, k12_check(tag, wave))
    k12_main = k12_times("caustic-glass's first wave", waves_b["caustic_bdpt"],
                         first("caustic_bdpt", "bdpt_connect_rays")[0],
                         first("caustic_bdpt", "bdpt_connect_weight")[0], 5)
    for name, t in k12_main.items():
        timing[name] = dict(t, library_ms=None, max_abs_err=k12_err)
    log(f"caustic-glass BDPT frame (phase 8): peak device memory "
        f"{frame_peaks['caustic_bdpt']:.2f} GiB; bdpt_connect_weight: {bdpt.CONNECT_WARPS} warps "
        f"a 32-lane tile")

    # K5s on caustic-glass's and cornell-bdpt's first launches: its live
    # splats and their most on one pixel (the atomics' contention), the
    # bound recounted from them
    def splat_time(tag, label):
        sp_args = first(tag, "film_add_splats")[0][1:]
        pix_s, L_s, lam_s = sp_args[:3]
        n_s, n_lam_s = pix_s.shape[0], lam_s.shape[0]
        err = compare_splats(sp_args)
        fk = filmlib.new_film((256, 256), dev)
        ms = graph_ms(lambda: film_kernel.add_splats_cuda(fk.splat, *sp_args))
        ms_plain = events_ms(lambda: film_kernel.add_splats_plain(fk.splat, *sp_args), 20)
        rgb_s = torch.rand((n_s, 3), device=dev)
        ms_lib = graph_ms(lambda: fk.splat.index_add_(0, pix_s, rgb_s))
        # live: a splat whose L row is not all zero (it reads its pixel id)
        # and whose XYZ is not zero (it adds)
        nonzero = (L_s != 0).any(1)
        reps_s = n_s // n_lam_s
        v = film_kernel.lane_values(L_s, lam_s.repeat(reps_s, 1), sp_args[3].repeat(reps_s, 1),
                                    torch.ones(n_s, device=dev))[:, :3]
        adds = (v != 0).any(1)
        lanes_read = int(nonzero.view(reps_s, n_lam_s).any(0).sum())
        px_live, px_count = torch.unique(pix_s[adds], return_counts=True)
        most = int(px_count.max()) if px_count.numel() else 0
        # adds that a warp could merge: a pixel's second and later adds among
        # one warp's 32 lanes at one strategy (splat m n_lam + j: warp j // 32)
        split = torch.arange(n_s, device=dev)
        group = (split // n_lam_s) * ((n_lam_s + 31) // 32) + (split % n_lam_s) // 32
        mergeable = int(adds.sum()) - torch.unique(
            torch.stack([group[adds], pix_s[adds]]), dim=1).shape[1]
        b = bound(n_s * 16 + int(nonzero.sum()) * 8 + lanes_read * 32 + 3 * 471 * 4
                  + px_live.numel() * 24, int(nonzero.sum()) * FILM_LANE_OPS)
        log(f"film_add_splats at {label} ({n_s} splats over {n_lam_s} lanes; {int(nonzero.sum())} "
            f"rows not all zero ({int(nonzero.sum()) / n_s:.2%}), {int(adds.sum())} adds into "
            f"{px_live.numel()} pixels, at most {most} on one pixel, {mergeable} on a pixel that "
            f"an earlier lane of the same warp and strategy adds to; {lanes_read} lanes read "
            f"their wavelengths): kernel {ms:.4f} ms, {ms / b[0]:.2f}x its bound {b[0]:.4f} ms "
            f"({b[1]}), plain {ms_plain:.3f} ms, index_add_ {ms_lib:.4f} ms; max abs err "
            f"{err:.2e} (rtol 1e-5)")
        return dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], library_ms=ms_lib,
                    max_abs_err=err, splats=n_s, live=int(adds.sum()), most_on_a_pixel=most,
                    mergeable_in_a_warp=mergeable)

    timing["film_add_splats"] = splat_time("caustic_bdpt", "caustic-glass BDPT's first launch")
    timing["film_add_splats"]["cornell_bdpt"] = splat_time("cornell_bdpt",
                                                           "cornell-bdpt's first launch")
    timing["film_add_splats"]["max_abs_err"] = max(
        splat_err, timing["film_add_splats"]["max_abs_err"],
        timing["film_add_splats"]["cornell_bdpt"]["max_abs_err"])

    phase_start("10")
    # ---- 10. MLT (K12m): cornell 24^2 on the card and the CPU with one
    # seed; the two full-width frames, cut in mutations per pixel; both
    # kernels against their plain versions at the frames' first passes, and
    # timed on caustic-glass's
    for integ in ("mltpath", "mltbdpt"):
        sc, mt = ts.cornell(res=24, spp=1, device=dev, filter_kind="box", integrator=integ)
        mt = dataclasses.replace(mt, mutations_per_pixel=mlt_cases.SMALL_MUTATIONS)
        runs = {}
        for d_ in (dev, torch.device("cpu")):
            acc = []
            reset_counts()
            img, st = mlt.render_mlt(
                sc, mt, n_chains=mlt_cases.SMALL_CHAINS, n_bootstrap=mlt_cases.SMALL_BOOTSTRAP,
                device=d_, on_pass=lambda i, a, acc=acc, d_=d_: acc.append(
                    mlt.accept_uniforms(0, i, mlt_cases.SMALL_CHAINS, d_) < a))
            runs[d_.type] = (img.cpu().numpy(), torch.stack(acc).cpu(), st,
                             {k: v for k, v in read_counts().items() if v})
        (img_g, acc_g, st_g, counts), (img_c, acc_c, st_c, _) = runs["cuda"], runs["cpu"]
        n_passes = acc_g.shape[0]
        require(counts.get("mlt_mutate") == n_passes == counts.get("mlt_accept_splat"), integ,
                counts)
        # mltpath's evaluations take the CUDA path step (the MLT kind), mltbdpt's none of K6
        k6_n = {k: counts.get(k, 0) for k in K6C}
        require(all(k6_n[k] > 0 for k in K6) and k6_n["path_coat"] == 0 if integ == "mltpath"
                else not any(k6_n.values()), integ, "K6 launches", k6_n)
        res = mlt_cases.compare_renders(img_g, img_c, acc_g, acc_c)
        log(f"small MLT render cornell {integ} 24^2, {mlt_cases.SMALL_CHAINS} chains x "
            f"{n_passes} passes, card vs cpu with one seed: accept decisions equal on "
            f"{res['decisions']:.4%} of (chain, pass) (>= {mlt_cases.DECISION_FRAC:.0%} "
            f"required), 8x8 block means worst {res['block_rel']:.4%} apart (<= "
            f"{mlt_cases.BLOCK_RTOL:.0%}), means {img_g.mean():.5f} / {img_c.mean():.5f}; rays "
            f"card {st_g['closest'] + st_g['shadow']} cpu {st_c['closest'] + st_c['shadow']}; "
            f"launches {counts}")

    s_cgm, m_cgm = compile_scene(bd.SceneBuilder().parse_file(
        str(ROOT / "scenes" / "caustic-glass.pbrt")), device=dev, integrator_override="mlt")
    s_cmm, m_cmm = ts.cornell_mesh(res=256, levels=5, device=dev, integrator="mltpath")
    require((m_cgm.resolution, m_cgm.max_depth, m_cgm.mutations_per_pixel, m_cmm.max_depth,
             m_cmm.n_tris) == ((256, 256), 7, 100, 5, 16396), "MLT frame settings")
    mlt_frames = (
        ("caustic_mlt", s_cgm, dataclasses.replace(m_cgm, mutations_per_pixel=4), "caustic_bdpt",
         ("dense_tri_closest", "dense_tri_any", "dense_spheres", "dense_spheres_any",
          "dense_disks", "bdpt_connect_rays", "bdpt_connect_weight")),
        ("cornell_mesh_mlt", s_cmm, dataclasses.replace(m_cmm, mutations_per_pixel=8),
         "cornell_mesh", ("bvh_closest_hit", "bvh_any_hit")))
    log("MLT frames at full width (256^2, the scene's max depth, 8192 chains), cut from 100 "
        "mutations per pixel (800 passes) to 4 (caustic-glass mlt: 32 passes) and 8 "
        "(cornell-mesh mltpath: 64 passes) so that this phase fits the script's time; "
        "python -m pbrt_tpu_torch.profile_render runs them uncut")
    for tag, sc, mt, ref, must in mlt_frames:
        with packing_counted() as packed:
            full_render(tag, sc, mt, must + ("mlt_mutate", "mlt_accept_splat"))
        require(not packed["calls"] and not any(main_counts_frame.get(k) for k in k12_yard), tag,
                "K12's yardsticks or their packing on the main path", packed, main_counts_frame)
        n_passes = max(1, mt.mutations_per_pixel * mt.resolution[0] * mt.resolution[1]
                       // mlt.N_CHAINS)
        got = {k: main_counts_frame[k] for k in mlt.launches}
        require(got == {k: n_passes for k in mlt.launches}, tag, "launches", got, n_passes)
        rel = abs(frame_means[tag] - frame_means[ref]) / frame_means[ref]
        require(rel <= mlt_cases.FRAME_MEAN_RTOL[tag], tag, "image mean", frame_means[tag],
                ref, frame_means[ref])
        log(f"{tag}: K12m-a and K12m-b launched once a pass ({n_passes}); image mean "
            f"{frame_means[tag]:.5f} vs the {ref} frame's {frame_means[ref]:.5f}: {rel:.3%} "
            f"apart (<= {mlt_cases.FRAME_MEAN_RTOL[tag]:.0%})")

    # K3, K3a, K4a and K4 (closest and any hit) at the cut caustic-glass-mlt
    # frame's first 8,192-lane evaluation (its occluded dispatch: 35
    # strategies' shadow rays a lane)
    for name, kind, tag in (("dense_tri_closest", "tris", "caustic_mlt"),
                            ("dense_tri_any", "any", "caustic_mlt"),
                            ("dense_disks", "disks", "caustic_mlt"),
                            ("dense_disks", "disks", "caustic_mlt_occluded")):
        args = (occluded_rays("caustic_mlt") + (dispatch._disks(s_cgm, m_cgm),)
                if tag == "caustic_mlt_occluded" else first(tag, name)[0])
        err = dense_check(kind, args)
        timing[name][tag] = dict(dense_time(
            kind, args, "caustic-glass-mlt's first " + (
                "occluded dispatch" if tag == "caustic_mlt_occluded" else "evaluation"),
            empty=dense_empty), max_abs_err=err)
        timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"], err)
    for name, kind, label in (
            ("dense_spheres", "spheres", "caustic-glass-mlt's first evaluation"),
            ("dense_spheres_any", "spheres_any", "caustic-glass-mlt's first occluded dispatch")):
        args = first("caustic_mlt", name)[0]
        err = dense_check(kind, args)
        timing[name]["caustic_mlt"] = dict(dense_time(kind, args, label, empty=dense_empty),
                                           max_abs_err=err)
        timing[name]["max_abs_err"] = max(timing[name]["max_abs_err"], err)

    # the cut cornell-mesh mltpath frame's passes on either route of the path
    # step (the plain one chosen by this script): 1 mutation per pixel (8
    # passes), the CUDA step first, the median of the 7 pass-to-pass times
    m_cmm8 = dataclasses.replace(m_cmm, mutations_per_pixel=1)
    mlt_turns = {}
    for route in ("cuda", "plain"):
        stamps = []

        def on_pass(i, a, stamps=stamps):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        t0 = time.perf_counter()
        on_route(route, lambda: mlt.render_mlt(s_cmm, m_cmm8, on_pass=on_pass))
        mlt_turns[route] = dict(median_pass_s=float(np.median(np.diff(stamps))),
                                passes=len(stamps), frame_s=time.perf_counter() - t0,
                                bootstrap_and_first_pass_s=stamps[0] - t0)
    timing["path_shade"]["cornell_mesh_mltpath_pass_s"] = {
        r: v["median_pass_s"] for r, v in mlt_turns.items()}
    log(f"cornell-mesh mltpath frame cut to {mlt_turns['cuda']['passes']} passes of "
        f"{mlt.N_CHAINS} chains, by route of the path step: median pass "
        f"{mlt_turns['cuda']['median_pass_s']:.4f} s on the CUDA step, "
        f"{mlt_turns['plain']['median_pass_s']:.4f} s on the plain step "
        f"({mlt_turns['plain']['median_pass_s'] / mlt_turns['cuda']['median_pass_s']:.2f}x); "
        f"frames {mlt_turns['cuda']['frame_s']:.3f} / {mlt_turns['plain']['frame_s']:.3f} s "
        f"(bootstrap and first pass {mlt_turns['cuda']['bootstrap_and_first_pass_s']:.3f} / "
        f"{mlt_turns['plain']['bootstrap_and_first_pass_s']:.3f} s)")

    # K12 at the MLT shape: the cut caustic-glass-mlt frame's first 8192-lane
    # evaluation (a bootstrap batch), against its plain version and its
    # yardsticks' bits, and timed
    wave_m = first("caustic_mlt", "bdpt_wave")[0]
    k12_err = max(k12_err, k12_check("caustic_mlt", wave_m))
    for name, t in k12_times("the caustic-glass-mlt frame's first 8192-lane evaluation", wave_m,
                             first("caustic_mlt", "bdpt_connect_rays")[0],
                             first("caustic_mlt", "bdpt_connect_weight")[0], 20).items():
        timing[name]["mlt_8192"] = t
        timing[name]["max_abs_err"] = k12_err

    mlt_err = {}
    for tag in ("caustic_mlt", "cornell_mesh_mlt"):
        (x_, seed_, pass_), _, _ = first(tag, "mlt_mutate")
        R_, D_ = x_.shape
        draws = torch.empty((R_, 1 + 2 * D_), device=dev)
        res_m = mlt_cases.compare_mutate(x_, mlt.mutate_cuda(x_, seed_, pass_, draws), draws,
                                         mlt.mutate_from_uniforms, mlt.chain_uniforms, seed_,
                                         pass_)
        (sp_, ht_, cur_, prop_, _, _), _, _ = first(tag, "mlt_accept_splat")
        res_a = mlt_cases.compare_accept(
            lambda *a: mlt.accept_and_splat_cuda(*a, seed_, pass_),
            lambda *a: mlt.accept_and_splat_from_uniforms(
                *a, mlt.accept_uniforms(seed_, pass_, R_, dev)), sp_, ht_, cur_, prop_)
        mlt_err["mlt_mutate"] = max(mlt_err.get("mlt_mutate", 0.0),
                                    res_m["max_ulps"] * 2.0 ** -24)
        mlt_err["mlt_accept_splat"] = max(mlt_err.get("mlt_accept_splat", 0.0),
                                          res_a["max_abs_err"])
        log(f"K12m vs plain on {tag}'s first pass ({R_} chains, D {D_}, C "
            f"{cur_.pix.shape[0]}): mlt_mutate draws bit-exact, {res_m['large']} large steps "
            f"equal, values within {res_m['max_ulps']:.0f} x 2^-24 (<= "
            f"{mlt_cases.MUTATE_ULPS}); mlt_accept_splat acceptance and chain state exact "
            f"({res_a['accepted']} accepted), splat and heat max abs err "
            f"{res_a['max_abs_err']:.3e} (<= {mlt_cases.SPLAT_RTOL:g} of the largest sum)")

    # timed on both frames' first passes: caustic-glass x (8192, 160), C = 8
    # (the kernels' entries of the kernels line); cornell-mesh x (8192, 66),
    # C = 1 (under the tag cornell_mesh_mltpath)
    clone_ch = lambda ch: type(ch)(*(t.clone() for t in ch))
    for tag in ("caustic_mlt", "cornell_mesh_mlt"):
        (x_, seed_, pass_), _, _ = first(tag, "mlt_mutate")
        R_, D_ = x_.shape
        ms = graph_ms(lambda: mlt.mutate_cuda(x_, seed_, pass_))
        ms_plain = events_ms(lambda: mlt.mutate_from_uniforms(
            x_, *mlt.chain_uniforms(seed_, pass_, R_, D_, dev)), 3)
        b = bound(R_ * D_ * 8, R_ * D_ * MUTATE_OPS)
        t_m = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], library_ms=None)
        log(f"mlt_mutate at {tag}'s first pass ({R_} chains x {D_}, {mlt.MUTATE_LANES} lanes a "
            f"chain): kernel {ms:.5f} ms, plain {ms_plain:.3f} ms (its 1 + 2 D stream draws "
            f"included), bound {b[0]:.5f} ms ({b[1]}; {R_ * D_ * 8 / 1e6:.2f} MB), "
            f"{ms / b[0]:.2f}x the bound")
        (sp_, ht_, cur_, prop_, seed_, pass_), _, _ = first(tag, "mlt_accept_splat")
        C_ = cur_.pix.shape[0]
        u_acc = mlt.accept_uniforms(seed_, pass_, R_, dev)
        y_c, y_p = cur_.y, prop_.y
        a_ = torch.where(y_c > 0, torch.clamp(y_p / torch.clamp(y_c, min=1e-12), max=1.0), 1.0)
        n_acc = int((u_acc < a_).sum())
        live = torch.cat([(cur_.rgb.abs().sum(-1) > 0) & (y_c > 0)[None],
                          (prop_.rgb.abs().sum(-1) > 0) & (y_p > 0)[None]])
        pix_all = torch.cat([cur_.pix, prop_.pix])
        n_touched = int(torch.unique(torch.cat([pix_all[live], cur_.pix[0],
                                                prop_.pix[0]])).numel())
        # reads: both states' y, pix and rgb; writes: a; an accepted chain's
        # proposal row read and its state row written; the touched pixels of
        # splat and heat read and written
        nbytes = (R_ * 8 + 2 * C_ * R_ * 16 + R_ * 4 + n_acc * (D_ * 8 + C_ * 16 + 4)
                  + n_touched * 16 * 2)
        b = bound(nbytes, R_ * 10 + int(live.sum()) * 3)
        cur_k, sp_k, ht_k = clone_ch(cur_), sp_.clone(), ht_.clone()
        ms = graph_ms(lambda: mlt.accept_and_splat_cuda(sp_k, ht_k, cur_k, prop_, seed_, pass_))
        cur_p, sp_p, ht_p = clone_ch(cur_), sp_.clone(), ht_.clone()
        ms_plain = events_ms(lambda: mlt.accept_and_splat_from_uniforms(
            sp_p, ht_p, cur_p, prop_, mlt.accept_uniforms(seed_, pass_, R_, dev)), 3)
        idx_all = pix_all.reshape(-1).long()
        rgb_all = torch.rand((idx_all.shape[0], 3), device=dev)
        ms_lib = graph_ms(lambda: sp_k.index_add_(0, idx_all, rgb_all))
        t_a = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], library_ms=ms_lib)
        log(f"mlt_accept_splat at {tag}'s first pass ({R_} chains, C {C_}, {n_acc} accepted, "
            f"{int(live.sum())} live contributions over {n_touched} pixels, "
            f"{mlt.ACCEPT_LANES} lanes a chain): kernel {ms:.5f} ms, plain {ms_plain:.3f} ms, "
            f"index_add_ of its {idx_all.shape[0]} splats {ms_lib:.4f} ms, bound {b[0]:.5f} ms "
            f"({b[1]}; {nbytes / 1e6:.2f} MB), {ms / b[0]:.2f}x the bound")
        if tag == "caustic_mlt":
            timing["mlt_mutate"] = dict(t_m, max_abs_err=mlt_err["mlt_mutate"])
            timing["mlt_accept_splat"] = dict(t_a, max_abs_err=mlt_err["mlt_accept_splat"])
        else:
            timing["mlt_mutate"]["cornell_mesh_mltpath"] = t_m
            timing["mlt_accept_splat"]["cornell_mesh_mltpath"] = t_a

    phase_start("11")
    yard_s = (phase_t["7"] - phase_t["6b"]) + (phase_t["11"] - phase_t["9"])
    log(f"phases 6b, 9 and 10 took {yard_s:.1f} s without the yardsticks' timings in turns "
        f"(path_shade_lane, layered_*_lane, K12's *_lane; their bits are still checked): "
        f"{YARDSTICK_PHASES_S - yard_s:.1f} s less than the {YARDSTICK_PHASES_S} s the same "
        f"phases took with them on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md)")
    # ---- 11. scene sharding: K11a, K11b and the select kernel
    # (a) against their plain versions, the unfused yardstick and K1 on
    # phase 3's rays over cornell-mesh levels 5 in 8 parts
    sh8 = ss.build_scene_shard(scene, 8).to(dev)
    full_b = sum(x.numel() * 4 for x in (scene.bvh_rows, scene.tri_rec, scene.tri_p0,
                                         scene.tri_p1, scene.tri_p2))
    part_b = ss.shard_bytes(sh8)
    require(part_b < full_b / 4, "per-part tables not under a quarter", part_b, full_b)
    log(f"cornell-mesh levels 5 in 8 parts: rows {tuple(sh8.rows.shape)}, recv "
        f"{tuple(sh8.recv.shape)}, n_int {sh8.n_int}, depth {sh8.depth}; {part_b / 1e6:.3f} MB "
        f"a part against {full_b / 1e6:.3f} MB of unsharded tables ({part_b / full_b:.3f})")

    def unfused_pack(sh, o, d, t_max):
        """The yardstick: K1 over each part, then an argmin over the parts
        and a gather of the winner's recv row (closest_parts_plain's
        arithmetic around bvh.traverse_cuda)."""
        ts_, rvs = [], []
        for p in range(sh.rows.shape[0]):
            t, prim = bvh.traverse_cuda(sh.rows[p], sh.n_int, sh.depth, o, d, t_max)
            found = prim >= 0
            ts_.append(torch.where(found, t, torch.inf))
            rvs.append(torch.where(found[:, None], sh.recv[p][prim.clamp(min=0)], 0.0))
        t = torch.stack(ts_)
        best = torch.argmin(t, dim=0)
        rr = torch.arange(o.shape[0], device=o.device)
        return torch.cat([t[best, rr][:, None], torch.stack(rvs)[best, rr]], dim=1)

    def unfused_any(sh, o, d, t_max):
        occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        for p in range(sh.rows.shape[0]):
            occ |= bvh.traverse_cuda(sh.rows[p], sh.n_int, sh.depth, o, d, t_max,
                                     any_hit=True)[1] >= 0
        return occ

    def pack_ties(pk, ref, o, d, t_max, what, ties_ok):
        """Lanes where the pack pk differs from ref: none, or (ties_ok) only
        verified ties, as K1's in phases 3 and 9: both winners are hits
        whose t agree within 1e-6 relative (a tie decided by the traversal
        order, or by the bound carried across parts). -> their count."""
        differ = (pk != ref).any(1)
        n = int(differ.sum())
        if n:
            require(ties_ok, what, "differs on", n, "lanes")
            ts_ = []
            for pack in (pk[differ], ref[differ]):
                tr, _, ok = ix.intersect_tri_lanes(o[differ], d[differ], t_max[differ],
                                                   pack[:, 28:31], pack[:, 31:34],
                                                   pack[:, 34:37])
                require(bool(ok.all()) and bool(torch.isfinite(pack[:, 0]).all()), what,
                        "a differing winner that misses")
                ts_ += [tr, pack[:, 0]]
            rel = max(float(((ts_[0] - ts_[2]).abs() / ts_[2].abs()).max()),
                      float(((ts_[1] - ts_[3]).abs() / ts_[3].abs()).max()))
            require(rel <= 1e-6, what, "a differing winner is not a tie", rel)
        return n

    def compare_parts(sh, o, d, t_max, full, ties_ok=False, plain=True):
        """K11a against its plain version (plain False: not run, the
        unfused yardstick's pack returned for it) and the unfused
        K1-per-part yardstick (bit for bit; with ties_ok, but for verified
        ties), and the unsharded K1 over full = (rows, n_int, depth, scene)
        -> (hits, lanes whose winner differs from K1's, max rel err of t
        against K1, (tie lanes against plain and unfused, max abs err of t
        against plain), plain ms, the plain pack; without plain: None, None,
        the unfused yardstick's err and pack)."""
        rows_f, nint_f, depth_f, sc_f = full
        pk = ss.closest_parts_cuda(sh.rows, sh.recv, sh.n_int, sh.depth, sh.top, o, d, t_max)
        pu = unfused_pack(sh, o, d, t_max)
        pp, ms_p, n_tp = pu, None, None
        if plain:
            pp, ms_p = timed(lambda: ss.closest_parts_plain(sh.rows, sh.recv, sh.n_int, o, d,
                                                            t_max))
            n_tp = pack_ties(pk, pp, o, d, t_max, "K11a against its plain version", ties_ok)
        n_ty = pack_ties(pk, pu, o, d, t_max, "K11a against the unfused K1-per-part yardstick",
                         ties_ok)
        t1, p1 = bvh.traverse_cuda(rows_f, nint_f, depth_f, o, d, t_max)
        hit = p1 >= 0
        require(torch.equal(hit, torch.isfinite(pk[:, 0])), "K11a: hit set differs from K1's")
        rel = ((pk[hit, 0] - t1[hit]).abs() / t1[hit].abs()).max() if bool(hit.any()) else 0.0
        require(float(rel) <= 1e-5, "K11a: t differs from K1's", float(rel))
        pc = p1.clamp(min=0)
        same = (pk[:, 28:] == torch.cat([sc_f.tri_p0[pc], sc_f.tri_p1[pc], sc_f.tri_p2[pc]],
                                        dim=1)).all(1) & hit
        n_hit, n_same = int(hit.sum()), int(same.sum())
        require(n_same >= 0.99 * n_hit, "K11a: winners differ from K1's", n_same, n_hit)
        other = hit & ~same
        if ties_ok:
            rel_o = ((pk[other, 0] - t1[other]).abs() / t1[other].abs()).max() \
                if bool(other.any()) else 0.0
            require(float(rel_o) <= 1e-6, "K11a: a different winner than K1's at another t")
        else:
            require(torch.equal(pk[other, 0], t1[other]), "K11a: a different winner at another t")
        both = torch.isfinite(pk[:, 0]) & torch.isfinite(pp[:, 0])
        err_t = float((pk[both, 0] - pp[both, 0]).abs().max()) if bool(both.any()) else 0.0
        return n_hit, n_hit - n_same, float(rel), (n_tp, n_ty, err_t), ms_p, pp

    def compare_any_parts(sh, o, d, t_max, full, plain=True):
        """K11b against its plain version (unless plain is False), the
        unfused K1a-per-part yardstick and the unsharded K1a -> (the
        occluded mask, plain ms or None)."""
        rows_f, nint_f, depth_f, _ = full
        ok = ss.any_parts_cuda(sh.rows, sh.n_int, sh.depth, sh.top, o, d, t_max)
        ms_p = None
        if plain:
            op, ms_p = timed(lambda: ss.any_parts_plain(sh.rows, sh.n_int, o, d, t_max))
            require(torch.equal(ok, op), "K11b differs from its plain version",
                    int((ok != op).sum()))
        require(torch.equal(ok, unfused_any(sh, o, d, t_max)), "K11b differs from the unfused "
                "yardstick")
        require(torch.equal(ok, bvh.traverse_cuda(rows_f, nint_f, depth_f, o, d, t_max,
                                                  any_hit=True)[1] >= 0),
                "K11b differs from the unsharded K1a")
        return ok, ms_p

    full_cm = (rows, n_int, depth, scene)
    o, d, t_max = camera_and_interior_rays(scene, meta)
    n_hit, n_tie, rel, _, _, _ = compare_parts(sh8, o, d, t_max, full_cm)
    t_cl, _ = bvh.traverse_cuda(rows, n_int, depth, o, d, t_max)
    occ_a, _ = compare_any_parts(sh8, o, d, shadow_t(t_cl), full_cm)
    log(f"bvh_closest_hit_parts vs plain on {o.shape[0]} camera+interior rays over 8 parts: "
        f"packs bit-exact (and with the unfused K1-per-part yardstick); against the "
        f"unsharded K1 {n_hit} hits, the same triangle on all but {n_tie} (equal t), max rel "
        f"err t {rel:.2e}; bvh_any_hit_parts {int(occ_a.sum())} occluded, bit-exact with "
        f"plain, the unfused yardstick and K1a")

    def planted_packs(pack, W=4):
        """W packs from one: rank w's rows rolled by 17 w, and on every third
        ray ranks 1 and 2 tied with rank 0's t."""
        packs = torch.stack([pack.roll(17 * w, dims=0) for w in range(W)]).contiguous()
        packs[1:3, ::3, 0] = packs[0, ::3, 0]
        return packs

    pk8 = ss.closest_parts_cuda(sh8.rows, sh8.recv, sh8.n_int, sh8.depth, sh8.top, o, d,
                                t_max)
    packs4 = planted_packs(pk8)
    require(torch.equal(ss.select_cuda(packs4), ss.select_plain(packs4)),
            "shard_select differs from its plain version")
    log(f"shard_select vs plain on 4 stacked packs of {o.shape[0]} rays, ties planted on every "
        f"third ray: bit-exact")

    # (b) the scene-sharded full-width frames through render(shard_parts=N)
    parts_k = ("bvh_closest_hit_parts", "bvh_any_hit_parts", "film_add_samples")

    def sharded_frame(tag, sc, mt, n_parts, ref_tag, ref_stats, must=parts_k, prebuilt=True):
        """A scene-sharded frame through render(): of the scene split by
        rd.shard_scene first (its host build and upload timed alone, the
        frame's wall time without it) or, prebuilt=False, through
        render(shard_parts=n_parts) as the CLI's --shard-scene calls it."""
        kw = {"shard_parts": n_parts}
        if prebuilt:
            t0 = time.time()
            sc = rd.shard_scene(sc, n_parts)
            torch.cuda.synchronize()
            log(f"{tag}: shard_scene ({n_parts} parts of rows {tuple(sc.shard.rows.shape)}, "
                f"host build and upload) {time.time() - t0:.2f} s")
            kw = {}
        st = full_render(tag, sc, mt, must + ("bvh_refit",), **kw)
        k1 = {k: main_counts_frame.get(k, 0) for k in bvh.launches if k != "bvh_refit"}
        require(not any(k1.values()), tag, "K1 launched on a sharded frame", k1)
        require(st == ref_stats, tag, "ray counts differ from the unsharded frame", st,
                ref_stats)
        fb = check_image(frame_imgs[tag], frame_imgs[ref_tag], f"{tag} vs {ref_tag}")
        log(f"{tag}: {n_parts} parts, ray counts equal to the {ref_tag} frame's {ref_stats}, "
            f"K1 not launched (the refit of K11a's winners, "
            f"bvh_refit, launched); vs that frame {fb:.4%} bad px, means "
            f"{frame_means[tag]:.5f} / {frame_means[ref_tag]:.5f}")
        return sc

    sc_cm8 = sharded_frame("cornell_mesh_sharded", scene, meta, 8, "cornell_mesh", st_cm)
    sc_terr4 = sharded_frame("terrain_sharded", s_terr, m_terr, 4, "terrain", st_terr_b)

    # the frames' walls in turns: cornell-mesh unsharded and in 8 parts
    # (K11a/K11b for K1/K1a), and terrain in 4 parts beside its batched loop
    walls = {k: [] for k in ("cornell_mesh", "cornell_mesh_sharded", "terrain_batched",
                             "terrain_sharded")}
    for tag in ("cornell_mesh", "cornell_mesh_sharded", "cornell_mesh_sharded", "cornell_mesh",
                "terrain_batched", "terrain_sharded", "terrain_sharded", "terrain_batched"):
        sc_w, mt_w = {"cornell_mesh": (scene, meta), "cornell_mesh_sharded": (sc_cm8, meta),
                      "terrain_sharded": (sc_terr4, m_terr)}.get(tag, (s_terr, m_terr))
        torch.cuda.synchronize()
        t0 = time.time()
        if tag == "terrain_batched":
            rd.render_batched(sc_w, mt_w, filmlib.new_film(mt_w.resolution, dev))
        else:
            rd.render(sc_w, mt_w)
        torch.cuda.synchronize()
        walls[tag].append(time.time() - t0)
    w_med = {k: float(np.median(v)) for k, v in walls.items()}
    ratio_cm = w_med["cornell_mesh_sharded"] / w_med["cornell_mesh"]
    log(f"frame walls in turns (unsharded, sharded, sharded, unsharded): cornell-mesh "
        f"{walls['cornell_mesh']} s against 8 parts {walls['cornell_mesh_sharded']} s "
        f"({ratio_cm:.3f}x; target <= 1.3x {'met' if ratio_cm <= 1.3 else 'missed'}); terrain "
        f"batched {walls['terrain_batched']} s against 4 parts {walls['terrain_sharded']} s "
        f"({w_med['terrain_sharded'] / w_med['terrain_batched']:.3f}x)")

    # (c) NCCL at world size 1: the collectives are issued (and counted)
    import torch.distributed as tdist

    issued = {"all_reduce": 0, "all_gather": 0}

    def counting(name):
        orig = getattr(tdist, name)

        def call(*a, **k):
            issued[name] += 1
            return orig(*a, **k)
        return orig, call

    store = kernels.BUILD_DIR / "nccl_world1"
    store.unlink(missing_ok=True)
    tdist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                             device_id=torch.device("cuda", torch.cuda.current_device()))
    origs = {n: counting(n) for n in issued}
    try:
        for n, (_, call) in origs.items():
            setattr(tdist, n, call)
        st = full_render("cornell_mesh_dp_nccl", scene, meta, ("bvh_closest_hit", "bvh_any_hit",
                                                               "film_add_samples"))
        require(st == st_cm, "NCCL pixel-parallel frame: ray counts", st, st_cm)
        require(issued["all_reduce"] >= 4, "NCCL pixel-parallel frame: no all_reduce", issued)
        fb = check_image(frame_imgs["cornell_mesh_dp_nccl"], frame_imgs["cornell_mesh"],
                         "NCCL pixel-parallel frame")
        log(f"NCCL world size 1, pixel-parallel cornell-mesh: the cornell_mesh frame's ray "
            f"counts, {issued['all_reduce']} all_reduce issued (film and counts), vs that frame "
            f"{fb:.4%} bad px")
        issued.update(all_reduce=0, all_gather=0)
        sharded_frame("cornell_mesh_sharded_nccl", scene, meta, 8, "cornell_mesh", st_cm,
                      must=parts_k + ("shard_select",), prebuilt=False)
        n_sel = main_counts_frame["shard_select"]
        require(issued["all_gather"] == n_sel == main_counts_frame["bvh_closest_hit_parts"]
                and issued["all_reduce"] == main_counts_frame["bvh_any_hit_parts"],
                "NCCL scene-sharded frame: collectives", issued, main_counts_frame)
        log(f"NCCL world size 1, scene-sharded cornell-mesh: {issued['all_gather']} all_gather "
            f"of the candidate packs, each resolved by shard_select, and {issued['all_reduce']} "
            f"all_reduce(MAX) of the shadow bits")
    finally:
        for n, (orig, _) in origs.items():
            setattr(tdist, n, orig)
        tdist.destroy_process_group()
    log("scaling across cards: not measurable on one card (one H100 in this machine; NCCL ran "
        "at world size 1)")

    # (d) K11a and K11b at their first launches in (b)'s frames, held again
    # (terrain's 2^20 lanes against the unfused yardstick and K1 only: its
    # plain versions take ~33 s on the H100) and timed in turns (K11,
    # unfused, K1, K1, unfused, K11) with the unfused yardstick (K1 over
    # each part) and K1/K1a over the unsharded table on the same rays,
    # beside the bound from ss.parts_work's oracle count (the answers: the
    # plain version's, on terrain the unfused yardstick's, its bits) and the
    # kernels' own work sums; the select kernel at its first launch in (c)
    work_w = (SLAB_VISIT_OPS, TRI_EDGE_OPS, TRI_RANGE_OPS, TRI_BOUND_OPS)
    full_terr = (s_terr.bvh_rows, m_terr.bvh_nint, m_terr.bvh_depth, s_terr)
    k11_timed = {"bvh_closest_hit_parts": {}, "bvh_any_hit_parts": {}}
    targets = {"bvh_closest_hit_parts": 0.90, "bvh_any_hit_parts": 1.10}
    for tag, full in (("cornell_mesh_sharded", full_cm), ("terrain_sharded", full_terr)):
        rows_f, nint_f, depth_f, _ = full
        for name in ("bvh_closest_hit_parts", "bvh_any_hit_parts"):
            any_hit = name == "bvh_any_hit_parts"
            a_ = first(tag, name)[0]
            if any_hit:
                rows_s, nint_s, depth_s, top_s, o_, d_, t_ = a_
                recv_s = None
            else:
                rows_s, recv_s, nint_s, depth_s, top_s, o_, d_, t_ = a_
            sh_f = ss.SceneShard(rows=rows_s, recv=recv_s, n_int=nint_s, depth=depth_s,
                                 leaf_k=bvh.LEAF_K, boxes=ss.part_boxes(rows_s), top=top_s)
            n_p, R_ = rows_s.shape[0], o_.shape[0]
            plain = tag == "cornell_mesh_sharded"
            if any_hit:
                occ_p, ms_plain = compare_any_parts(sh_f, o_, d_, t_, full, plain)
                t_lim, n_h, err_t = t_, int(occ_p.sum()), 0.0
                ties = "bit-exact with " + ("plain and " if plain else "") + "the unfused yardstick"
                fns = {"k11": lambda st=None: ss.any_parts_cuda(
                           rows_s, nint_s, depth_s, top_s, o_, d_, t_, stats=st),
                       "unfused": lambda st=None: unfused_any(sh_f, o_, d_, t_),
                       "k1": lambda st=None: bvh.traverse_cuda(rows_f, nint_f, depth_f, o_, d_,
                                                               t_, True, stats=st)}
                nbytes = rows_s.numel() * 4 + top_s.numel() * 4 + R_ * 29
            else:
                n_h, n_tie, rel, (n_tp, n_ty, err_t), ms_plain, pp = compare_parts(
                    sh_f, o_, d_, t_, full, ties_ok=True, plain=plain)
                occ_p = None
                t_lim = torch.where(torch.isfinite(pp[:, 0]), pp[:, 0], t_)
                ties = (f"bit-exact but {n_tp} verified tie lanes against plain, " if plain
                        else "bit-exact but ") + (
                        f"{n_ty} against the unfused yardstick; the same triangle as the "
                        f"unsharded K1 on all but {n_tie} hits, max rel err t {rel:.2e}")
                fns = {"k11": lambda st=None: ss.closest_parts_cuda(
                           rows_s, recv_s, nint_s, depth_s, top_s, o_, d_, t_, stats=st),
                       "unfused": lambda st=None: unfused_pack(sh_f, o_, d_, t_),
                       "k1": lambda st=None: bvh.traverse_cuda(rows_f, nint_f, depth_f, o_, d_,
                                                               t_, stats=st)}
                nbytes = (rows_s.numel() * 4 + top_s.numel() * 4 + n_h * ss.REC_W * 4 + R_ * 28
                          + R_ * ss.PACK_W * 4)
            oracle = ss.parts_work(rows_s, nint_s, sh_f.boxes, o_, d_, t_lim, occ_p, work_w)
            own = {}
            for key in ("k11", "k1"):
                work = torch.zeros(4, dtype=torch.int64, device=dev)
                fns[key](work)
                own[key] = tuple(int(x) for x in work.cpu())
            turns = {k: [] for k in fns}
            for key in ("k11", "unfused", "k1", "k1", "unfused", "k11"):
                turns[key].append(graph_ms(fns[key]))
            ms_ = {k: sum(v) / len(v) for k, v in turns.items()}
            b = bound(nbytes, oracle[0] * SLAB_VISIT_OPS + tri_test_ops(*oracle[1:]))
            rows_x = own["k11"][0] / own["k1"][0]
            k11_timed[name][tag] = dict(
                ms=ms_["k11"], unfused_ms=ms_["unfused"], k1_same_rays_ms=ms_["k1"], turns=turns,
                plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1], lanes=R_, parts=n_p,
                live=int((t_ > 0).sum()), found=n_h, oracle_work=oracle, kernel_stats=own["k11"],
                k1_stats=own["k1"], max_abs_err=err_t)
            tgt = ""
            if tag == "cornell_mesh_sharded":
                tgt = (f"; target <= {targets[name]} ms "
                       f"{'met' if ms_['k11'] <= targets[name] else 'missed'}")
                if not any_hit:
                    tgt += (f", rows read {rows_x:.2f}x K1's (target <= 1.5x "
                            f"{'met' if rows_x <= 1.5 else 'missed'})")
            log(f"{name} at {tag}'s first launch ({R_} lanes x {n_p} parts, "
                f"{int((t_ <= 0).sum())} masked, {n_h} {'occluded' if any_hit else 'hits'}; "
                f"{ties}): kernel {turns['k11']} ms, unfused per part {turns['unfused']} ms, "
                f"{'K1a' if any_hit else 'K1'} over the unsharded table on the same rays "
                f"{turns['k1']} ms (in turns; {ms_['k11'] / ms_['k1']:.3f}x K1); plain "
                f"{'not run' if ms_plain is None else f'{ms_plain:.1f} ms'}; oracle work (rows, "
                f"tri tests, past edge, past range) {oracle}, bound {b[0]:.4f} ms ({b[1]}), "
                f"kernel {ms_['k11'] / b[0]:.1f}x it; the kernels' own sums: K11 {own['k11']}, "
                f"K1 {own['k1']} (rows read {rows_x:.2f}x K1's){tgt}")
    for name, per in k11_timed.items():
        cm = per["cornell_mesh_sharded"]
        timing[name] = dict(ms=cm["ms"], plain_ms=cm["plain_ms"], bound_ms=cm["bound_ms"],
                            bound_by=cm["bound_by"], library_ms=None,
                            max_abs_err=max(x["max_abs_err"] for x in per.values()),
                            unfused_ms=cm["unfused_ms"],
                            k1_same_rays_ms=cm["k1_same_rays_ms"], launches_timed=per)
    (packs_s,), _, _ = first("cornell_mesh_sharded_nccl", "shard_select")
    W_, R_ = packs_s.shape[0], packs_s.shape[1]
    out_p, _ = timed(lambda: ss.select_plain(packs_s))
    require(torch.equal(ss.select_cuda(packs_s), out_p), "shard_select differs on the main "
            "path's launch")
    ms, call = kernel_ms(lambda: ss.select_cuda(packs_s))
    ms_plain = events_ms(lambda: ss.select_plain(packs_s), 20)
    b = bound((W_ + 1) * R_ * ss.PACK_W * 4, W_ * R_)
    timing["shard_select"] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                  library_ms=None, max_abs_err=0.0)
    log(f"shard_select at the main path's launch ({W_} rank x {R_} packs): kernel {ms:.4f} ms "
        f"(host-paced {call:.4f} ms), plain {ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}); "
        f"bit-exact")

    phase_start("12")
    # ---- 12. instancing (K1i) on the instanced cornell box
    def inst_scene(levels, mode, res=256, spp=16, filt=None, integrator=None):
        """(builder, scene, meta) of the instanced cornell box under
        instancing `mode`, compiled on the card."""
        b = ts.instanced_cornell_builder(levels, res, spp, mode, filt)
        sc, mt = compile_scene(b, device=dev, integrator_override=integrator)
        return b, sc, mt

    def inst_rays(sc, mt):
        """131,072 camera rays and 131,072 rays from random points of the
        box inside the scene's bounding sphere; every 97th lane masked."""
        p_film = torch.rand((131072, 2), generator=g) * torch.tensor(mt.resolution,
                                                                      dtype=torch.float32)
        rays = perspective.generate_rays(sc, p_film.to(dev), torch.zeros((131072, 2),
                                                                          device=dev))
        c, r = sc.scene_center.cpu(), float(sc.scene_radius)
        o_in = c + 0.55 * r * (2.0 * torch.rand((131072, 3), generator=g) - 1.0)
        d_in = torch.randn((131072, 3), generator=g)
        d_in = d_in / d_in.norm(dim=-1, keepdim=True)
        o = torch.cat([rays.o, o_in.to(dev)]).contiguous()
        d = torch.cat([rays.d, d_in.to(dev)]).contiguous()
        t_max = torch.full((o.shape[0],), INFINITY, device=dev)
        t_max[::97] = 0.0
        return o, d, t_max

    def inst_args(sc, mt):
        return sc.bvh_rows, mt.bvh_nint, mt.bvh_ninst, mt.bvh_depth, mt.bvh_iterb

    def compare_inst(args, leaves, o, d, t_max):
        """K1i (launch arguments `args` but the rays) vs plain closest hit
        (the scene's bvh_leaves): prim, inst and t bit-exact but on verified
        ties (K1's criterion). -> (hits, instanced hits, ties, plain t, max
        abs err of t, plain ms)."""
        tk, pk, ik = bvh.traverse_inst_cuda(*args, o, d, t_max)
        (tp, pp, ip), ms_p = timed(lambda: bvh.traverse_inst_plain(
            args[0], args[1], leaves, o, d, t_max))
        require(torch.equal(pk >= 0, pp >= 0), "K1i closest hit: hit/miss disagree")
        same = (pk == pp) & (ik == ip)
        require(torch.equal(tk[same], tp[same]), "K1i: t differs on the same winner")
        differ = ~same
        if bool(differ.any()):
            rel = (tk[differ] - tp[differ]).abs() / tp[differ].abs()
            require(float(rel.max()) <= 1e-6, "K1i winner disagreement is not a tie",
                    float(rel.max()))
        hit = pp >= 0
        err = float((tk - tp).abs()[hit].max()) if bool(hit.any()) else 0.0
        return int(hit.sum()), int((ip >= 0).sum()), int(differ.sum()), tp, err, ms_p

    def compare_inst_any(args, leaves, o, d, t_max):
        """K1i any hit vs plain: the bits equal. -> (the occluded mask, plain
        ms)."""
        ak = bvh.traverse_inst_cuda(*args, o, d, t_max, any_hit=True)[1]
        ap, ms_p = timed(lambda: bvh.traverse_inst_plain(args[0], args[1], leaves, o, d,
                                                         t_max, any_hit=True)[1])
        require(torch.equal(ak >= 0, ap >= 0), "K1i any hit disagrees on",
                int(((ak >= 0) != (ap >= 0)).sum()))
        return ap >= 0, ms_p

    # (a) levels (3, 2), every instance shared, against the plain version and
    # against K1 on the same scene flattened
    _, s_ia, m_ia = inst_scene((3, 2), "bvh")
    _, s_fa, m_fa = inst_scene((3, 2), "flatten")
    require(m_ia.bvh_ninst == 52 and m_fa.bvh_ninst == 0, "instanced (3, 2) scenes",
            m_ia.bvh_ninst, m_fa.bvh_ninst)
    o_a, d_a, t_a = inst_rays(s_ia, m_ia)
    n_h, n_hi, n_tie, t_cl, _, _ = compare_inst(inst_args(s_ia, m_ia), m_ia.bvh_leaves, o_a, d_a,
                                                t_a)
    occ_a, _ = compare_inst_any(inst_args(s_ia, m_ia), m_ia.bvh_leaves, o_a, d_a, shadow_t(t_cl))
    n_o = int(occ_a.sum())
    tf_, pf_ = bvh.traverse_cuda(s_fa.bvh_rows, m_fa.bvh_nint, m_fa.bvh_depth, o_a, d_a, t_a)
    ti_, pi_, ii_ = bvh.traverse_inst_cuda(*inst_args(s_ia, m_ia), o_a, d_a, t_a)
    hi_, hf_ = pi_ >= 0, pf_ >= 0
    mask_eq = float((hi_ == hf_).float().mean())
    both = hi_ & hf_
    # The twins are the same triangles rounded apart (R12): flattening
    # stores each vertex as fl32(o2w p), within 2^-24 of its magnitude; K1i
    # keeps p and moves the ray, o' = fl(W o + w), d' = fl(W d), with W the
    # float32 w2o, each a chain of three roundings (csrc/bvh_ray.cuh
    # `dot_row`), which render space sees magnified by W's condition number
    # kappa. So the ray meets geometries apart by at most
    # delta = 2^-24 (1 + 4 kappa) (|o| + t) (|o| the origin's largest
    # coordinate, t the hit's distance, both bounding the hit point's
    # coordinates; the factor 2 of a 3-vector's length over its largest
    # coordinate taken in), and on one triangle the hit moves along the ray
    # by delta / |cos theta|, theta between the ray and the triangle's
    # normal: unbounded as the ray grazes it. The margin is that term (from
    # the flattened winner's normal) added to an rtol of 1e-4 plus 1e-5 |o|
    # (the margin before the grazing term). Where the ray grazes, the watertight test's conservative t
    # error bound (delta_t, which grows as 1 / |det|, the projected area)
    # can also reject a hit in one twin and keep it in the other (delta_t
    # differs by the basis of the shear, not by rounding), so the winners
    # differ: such a lane must show that the nearer winner's twin in the
    # other geometry passes the edge and t-range tests and is rejected by
    # that bound alone.
    L0_a = m_ia.bvh_leaves[0][0]
    w2o4 = torch.eye(4, dtype=torch.float64, device=dev).repeat(m_ia.bvh_ninst, 1, 1)
    w2o4[:, :3] = s_ia.inst_w2o.double().reshape(-1, 3, 4)
    o2w = torch.linalg.inv(w2o4)[:, :3]
    kappa = torch.linalg.cond(w2o4[:, :3, :3])
    flat_p = torch.stack([s_fa.tri_p0, s_fa.tri_p1, s_fa.tri_p2], 1).double()
    inst_p = torch.stack([s_ia.tri_p0, s_ia.tri_p1, s_ia.tri_p2], 1).double()

    def to_render(k, p):
        """(..., 3, 3) object-space vertices of instance k in render space"""
        return p @ o2w[k, :, :3].T + o2w[k, :, 3] if k >= 0 else p

    def twin(p, cands):
        """index in cands (N, 3, 3) of the triangle equal to p (3, 3) within
        2^-18 of the coordinates' magnitude, or -1"""
        err = (cands - p).abs().amax((1, 2))
        j = int(err.argmin())
        return j if float(err[j]) <= 2.0 ** -18 * float(p.abs().max()) else -1

    def rejected_by_bound(o1, d1, p):
        """the triangle p (3, 3) passes the watertight edge and t-range tests
        of the ray (o1, d1) and the test still misses: its t error bound"""
        p = p.float()
        t_inf = torch.full((1,), INFINITY, device=dev)
        edge, rng = bvh.watertight_stages(o1, d1, t_inf, p[None, 0], p[None, 1], p[None, 2])
        hit = ix.intersect_tri_lanes(o1, d1, t_inf, p[None, 0], p[None, 1], p[None, 2])[2]
        return bool(edge & rng & ~hit)

    pc_f = pf_.clamp(min=0)
    n_f = torch.cross(flat_p[pc_f, 1] - flat_p[pc_f, 0], flat_p[pc_f, 2] - flat_p[pc_f, 0], dim=-1)
    cos_f = ((n_f * d_a.double()).sum(-1).abs() / (n_f.norm(dim=-1) * d_a.double().norm(dim=-1))
             .clamp(min=1e-300)).float()
    o_mag = o_a.abs().amax(1)
    kap = torch.where(ii_ >= 0, kappa[ii_.clamp(min=0)].float(), 0.0)
    dt_all = (ti_ - tf_).abs()
    margin_old = 1e-4 * tf_.abs() + 1e-5 * o_mag
    margin = margin_old + 2.0 ** -24 * (1 + 4 * kap) * (o_mag + tf_.abs()) / cos_f.clamp(min=1e-30)
    dt = dt_all[both]
    t_rel = float((dt <= 1e-4 * tf_[both].abs()).float().mean())
    t_old = float((dt <= margin_old[both]).float().mean())
    outside = (both & (dt_all > margin)).nonzero()[:, 0].tolist()
    graze = []
    for lane in outside:    # winners that differ, each at a grazing hit
        o1, d1 = o_a[lane: lane + 1], d_a[lane: lane + 1]
        k = int(ii_[lane])
        p_i = to_render(k, inst_p[pi_[lane]])
        require(twin(p_i, flat_p[pf_[lane]][None]) < 0, "K1i vs K1 flattened: one triangle, t "
                "outside the derived margin", lane, float(dt_all[lane]), float(margin[lane]))
        if float(tf_[lane]) < float(ti_[lane]):      # K1i missed the flat winner's twin
            found = False
            for k2, (lo, hi) in enumerate(m_ia.bvh_leaves, -1):   # static, then instances
                lo, hi = lo - L0_a, hi - L0_a
                j = twin(flat_p[pf_[lane]], to_render(k2, inst_p[lo * 8: hi * 8]))
                if j >= 0:
                    oo, do = (o1, d1) if k2 < 0 else bvh.object_rays(s_ia.inst_w2o[k2], o1, d1)
                    found = rejected_by_bound(oo, do, inst_p[lo * 8 + j])
                    break
        else:                                        # K1 missed the K1i winner's twin
            j = twin(p_i, flat_p)
            found = j >= 0 and rejected_by_bound(o1, d1, flat_p[j])
        require(found, "K1i vs K1 flattened: winners differ, and not by the t error bound of a "
                "grazing hit", lane, float(tf_[lane]), float(ti_[lane]))
        graze.append((lane, round(float(tf_[lane]), 4), round(float(ti_[lane]), 4),
                      float(cos_f[lane])))
    require(mask_eq >= 0.9999, "K1i vs K1 flattened: hit masks", mask_eq)
    log(f"instanced cornell (3, 2), {m_ia.bvh_ninst} instances, {s_ia.bvh_rows.shape[0]} rows "
        f"(flattened: {m_fa.n_tris} tris, {s_fa.bvh_rows.shape[0]} rows): K1i vs plain on "
        f"{o_a.shape[0]} camera+interior rays: {n_h} hits ({n_hi} in instances), {n_tie} "
        f"verified ties, t bit-exact on the same winner; any hit {n_o} occluded, 0 disagree; "
        f"against K1 on the flattened scene: hit masks equal on {mask_eq:.6%} of lanes, t "
        f"within rtol 1e-4 on {t_rel:.4%} of common hits, within rtol 1e-4 plus 1e-5 of "
        f"the origin's magnitude on {t_old:.4%}, within that plus the grazing term on all but "
        f"{len(graze)}, whose winners differ by the t error bound of a grazing hit (lane, K1 t, "
        f"K1i t, |cos|): {graze}; instance condition numbers up to {float(kappa.max()):.4f}")

    # (b) small renders: path 48^2 x 4 (card, CPU, card flattened), BDPT
    # 24^2 x 8 (card, CPU), mltpath 24^2 (card, CPU, one seed)
    k1i = ("bvh_closest_hit_inst", "bvh_any_hit_inst")
    k1 = ("bvh_closest_hit", "bvh_any_hit")
    for label, mode, res, spp, integ in (("path 48^2 x 4", "bvh", 48, 4, None),
                                          ("bdpt 24^2 x 8", "bvh", 24, 8, "bdpt")):
        _, sc, mt = inst_scene((3, 2), mode, res=res, spp=spp, filt="box", integrator=integ)
        reset_counts()
        img_gpu, st_gpu = rd.render(sc, mt, return_stats=True)
        img_gpu = img_gpu.cpu().numpy()
        counts = {k: v for k, v in read_counts().items() if v}
        must = k1i + (("bdpt_connect_rays", "bdpt_connect_weight", "film_add_splats")
                      if integ else ("film_add_samples",))
        require(all(counts.get(k, 0) > 0 for k in must) and not any(k in counts for k in k1),
                label, "launches", counts)
        img_cpu, st_cpu = rd.render(sc, mt, device="cpu", return_stats=True)
        img_cpu = img_cpu.numpy()
        fb_c = check_image(img_gpu, img_cpu, f"instanced {label} vs cpu render")
        n_g, n_c = sum(st_gpu.values()), sum(st_cpu.values())
        require(abs(n_g - n_c) <= 1e-3 * n_c, label, "ray counts", st_gpu, st_cpu)
        msg = (f"small instanced render {label}: vs cpu {fb_c:.4%} bad px, rays card {n_g} cpu "
               f"{n_c}, means {img_gpu.mean():.5f} / {img_cpu.mean():.5f}; launches {counts}")
        if not integ:
            _, sf, mf = inst_scene((3, 2), "flatten", res=res, spp=spp, filt="box")
            img_f, st_f = rd.render(sf, mf, return_stats=True)
            fb_f = check_image(img_gpu, img_f.cpu().numpy(), f"instanced {label} vs flattened")
            require(abs(sum(st_f.values()) - n_g) <= 1e-3 * n_g, "flattened ray count", st_f)
            msg += f"; vs the card's flattened render {fb_f:.4%} bad px, rays {sum(st_f.values())}"
        log(msg)
    _, sc, mt = inst_scene((3, 2), "bvh", res=24, spp=1, filt="box", integrator="mltpath")
    mt = dataclasses.replace(mt, mutations_per_pixel=mlt_cases.SMALL_MUTATIONS)
    runs = {}
    for d_ in (dev, torch.device("cpu")):
        acc = []
        reset_counts()
        img, st = mlt.render_mlt(
            sc, mt, n_chains=mlt_cases.SMALL_CHAINS, n_bootstrap=mlt_cases.SMALL_BOOTSTRAP,
            device=d_, on_pass=lambda i, a, acc=acc, d_=d_: acc.append(
                mlt.accept_uniforms(0, i, mlt_cases.SMALL_CHAINS, d_) < a))
        runs[d_.type] = (img.cpu().numpy(), torch.stack(acc).cpu(), st,
                         {k: v for k, v in read_counts().items() if v})
    (img_g, acc_g, st_g, counts), (img_c, acc_c, st_c, _) = runs["cuda"], runs["cpu"]
    n_passes = acc_g.shape[0]
    require(counts.get("mlt_mutate") == n_passes == counts.get("mlt_accept_splat")
            and all(counts.get(k, 0) > 0 for k in k1i), "instanced mltpath", counts)
    res = mlt_cases.compare_renders(img_g, img_c, acc_g, acc_c)
    log(f"small instanced MLT render mltpath 24^2, {mlt_cases.SMALL_CHAINS} chains x {n_passes} "
        f"passes, card vs cpu with one seed: accept decisions equal on {res['decisions']:.4%} "
        f"(>= {mlt_cases.DECISION_FRAC:.0%} required), 8x8 block means worst "
        f"{res['block_rel']:.4%} apart (<= {mlt_cases.BLOCK_RTOL:.0%}), means "
        f"{img_g.mean():.5f} / {img_c.mean():.5f}; launches {counts}")

    # (c) the full-width frame cornell-instanced, then its flattened twin,
    # then both rendered in turns
    def table_bytes(sc):
        return (sc.bvh_rows.numel() + sc.tri_rec.numel()) * 4

    inst_frame = {}
    for tag, mode in (("cornell_instanced", "auto"), ("cornell_instanced_flat", "flatten")):
        t0 = time.time()
        b_, sc, mt = inst_scene(INST_LEVELS, mode)
        compile_s = time.time() - t0
        n_flat = len(b_.tri_p)
        n_proto = sum(p["P"].shape[0] for p in b_.protos)
        n_world = n_flat + sum(b_.protos[i["proto"]]["P"].shape[0] for i in b_.instances)
        require(n_world == 425996 and (mode == "flatten" or (
            n_flat, len(b_.instances), len(b_.protos), n_proto) == (253964, 21, 2, 16384)),
            tag, "triangle split", n_world, n_flat, len(b_.instances), n_proto)
        log(f"{tag} compile: {compile_s:.2f} s (parse, loop subdivision, host build of "
            f"{'both levels' if mt.bvh_ninst else 'one level'}): {n_world} world triangles, "
            f"{n_flat} stored flat, {len(b_.instances)} instances of {len(b_.protos)} "
            f"prototypes ({n_proto} triangles); {sc.bvh_rows.shape[0]} rows, depth "
            f"{mt.bvh_depth}; bvh_rows + tri_rec {table_bytes(sc) / 2**20:.2f} MiB")
        del b_
        st = full_render(tag, sc, mt, (k1i if mt.bvh_ninst else k1) + ("film_add_samples",))
        require(not any(k in main_counts_frame for k in (k1 if mt.bvh_ninst else k1i)), tag,
                "launched the other traversal", main_counts_frame)
        inst_frame[tag] = dict(scene=sc, meta=mt, stats=st, walls=[], rates=[],
                               peak=torch.cuda.max_memory_allocated(), bytes=table_bytes(sc),
                               compile=compile_s)
    # the frames in turns (instanced, twin, twin, instanced) FRAME_ROUNDS
    # times: honest rays/s (median, quartiles) and frame seconds (median) of
    # each, and each round's ratio
    for tag in ("cornell_instanced", "cornell_instanced_flat", "cornell_instanced_flat",
                "cornell_instanced") * FRAME_ROUNDS:
        x = inst_frame[tag]
        torch.cuda.synchronize()
        t0 = time.time()
        _, st = rd.render(x["scene"], x["meta"], return_stats=True)
        torch.cuda.synchronize()
        x["walls"].append(time.time() - t0)
        x["rates"].append((st["closest"] + st["shadow"]) / x["walls"][-1])
    for tag, x in inst_frame.items():
        q1, x["rate"], q3 = np.percentile(x["rates"], [25, 50, 75])
        x["wall"] = float(np.median(x["walls"]))
        log(f"{tag}: honest rays/s median {x['rate'] / 1e6:.3f} M (quartiles {q1 / 1e6:.3f} .. "
            f"{q3 / 1e6:.3f}) over {len(x['walls'])} renders in turns with the other, frame "
            f"{x['wall']:.4f} s median (walls {[round(w, 4) for w in x['walls']]}), peak mem "
            f"{x['peak'] / 2**30:.2f} GiB, tables {x['bytes'] / 2**20:.2f} MiB")
    fi, ff = inst_frame["cornell_instanced"], inst_frame["cornell_instanced_flat"]
    frame_x = fi["wall"] / ff["wall"]
    round_x = [(fi["walls"][2 * r] + fi["walls"][2 * r + 1])
               / (ff["walls"][2 * r] + ff["walls"][2 * r + 1]) for r in range(FRAME_ROUNDS)]
    rq1, rmed, rq3 = np.percentile(round_x, [25, 50, 75])
    verdict = "met" if rq3 <= 1.3 else "missed" if rq1 > 1.3 else "not established"
    log(f"cornell-instanced frame {frame_x:.3f}x its flattened twin's in turns (medians); "
        f"ratio of each round's frames median {rmed:.3f}x (quartiles {rq1:.3f} .. {rq3:.3f}, "
        f"rounds {[round(x, 3) for x in round_x]}); target <= 1.3x {verdict}")
    n_i, n_f = (sum(x["stats"].values()) for x in (fi, ff))
    require(abs(n_i - n_f) <= 0.01 * n_f, "instanced vs flattened ray counts", n_i, n_f)
    # the twins are not the same float32 geometry (flattening rounds the
    # vertices in render space, K1i the ray in object space): nearly every
    # path is the same (the ray counts differ by ~1e-6), but a path that an
    # ulp turns apart at a glass or glossy surface moves its pixel at 16 spp.
    # So the frames are held to check_image's mean rule and its per-pixel
    # tolerance on >= 98 % of pixel values (0.82 % fell outside it in one
    # run on an H100); (b) holds the small render to check_image itself. The
    # noise floor shows what the 2 % rule tells apart: the flattened twin
    # against its own second estimate (samples 16..31 of every pixel, the
    # same batched loop) must fall outside it. Where the bad pixels lie is
    # read from the material of each pixel centre's first hit.
    img_i, img_f = frame_imgs["cornell_instanced"], frame_imgs["cornell_instanced_flat"]
    s_ff, m_ff = ff["scene"], ff["meta"]
    W_, H_ = m_ff.resolution
    film2 = filmlib.new_film(m_ff.resolution, dev)
    for ids, sids, k_ in rd.wave_lanes(W_ * H_, m_ff.spp, dev):
        rd.render_wave(s_ff, m_ff, film2, ids, sids + m_ff.spp, k_)
    img_f2 = filmlib.develop(film2, m_ff.resolution, out_matrix=m_ff.film_out_matrix,
                             imaging_ratio=m_ff.film_imaging_ratio).cpu().numpy()
    ys, xs = torch.meshgrid(torch.arange(H_), torch.arange(W_), indexing="ij")
    p_c = (torch.stack([xs.reshape(-1), ys.reshape(-1)], 1).float() + 0.5).to(dev)
    rays_c = perspective.generate_rays(s_ff, p_c, torch.zeros_like(p_c))
    hit_c = dispatch.intersect(s_ff, m_ff, rays_c.o, rays_c.d,
                               torch.full((W_ * H_,), INFINITY, device=dev))
    kind = torch.where(hit_c.valid, s_ff.mat_type[hit_c.mat.clamp(min=0)], -1)
    kind = kind.reshape(H_, W_).cpu().numpy()
    on_gem, on_ball = kind == bd.MAT_DIELECTRIC, kind == bd.MAT_CONDUCTOR

    def twin_reading(img, ref):
        """(share of pixel values outside check_image's tolerance, pixels
        with such a value, their shares on the gems and on the balls)"""
        bad = np.abs(img - ref) > 5e-3 + 0.05 * np.abs(ref)
        px = bad.any(-1)
        n = max(int(px.sum()), 1)
        return float(bad.mean()), int(px.sum()), (px & on_gem).sum() / n, (px & on_ball).sum() / n

    px_bad, n_px, gem_i, ball_i = twin_reading(img_i, img_f)
    floor_bad, n_px_f, gem_f, ball_f = twin_reading(img_f2, img_f)
    mean_rel = abs(float(img_i.mean()) / float(img_f.mean()) - 1.0)
    require(np.isfinite(img_i).all() and px_bad < 0.02 < floor_bad and mean_rel < 0.01,
            "cornell-instanced vs its flattened twin (and the twin's noise floor)", px_bad,
            floor_bad, mean_rel)
    log(f"cornell-instanced against its flattened twin: rays {n_i} / {n_f} "
        f"({n_i / n_f - 1:+.4%}), per pixel value {px_bad:.4%} bad (< 2 %), means "
        f"{img_i.mean():.5f} / {img_f.mean():.5f} ({mean_rel:.4%} apart); noise floor, the "
        f"twin against its second estimate (samples 16..31): {floor_bad:.4%} bad (> 2 %), "
        f"means {img_f2.mean():.5f} / {img_f.mean():.5f}; pixels with a bad value: twins "
        f"{n_px}, {gem_i:.2%} on the gems and {ball_i:.2%} on the balls; floor {n_px_f}, "
        f"{gem_f:.2%} / {ball_f:.2%}; the gems are {on_gem.mean():.2%} of the frame's "
        f"pixels, the balls {on_ball.mean():.2%}; "
        f"rays/s {fi['rate'] / 1e6:.3f} / "
        f"{ff['rate'] / 1e6:.3f} M ({fi['rate'] / ff['rate']:.3f}x), frame {fi['wall']:.4f} / "
        f"{ff['wall']:.4f} s, peak {fi['peak'] / 2**30:.2f} / {ff['peak'] / 2**30:.2f} GiB, "
        f"tables {fi['bytes'] / 2**20:.2f} / {ff['bytes'] / 2**20:.2f} MiB "
        f"({ff['bytes'] / fi['bytes']:.2f}x), compile {fi['compile']:.2f} / "
        f"{ff['compile']:.2f} s")

    # (d) K1i at its first launches in the instanced frame (2^20 lanes): held
    # against its plain version on those arguments, and timed in turns with
    # the flattened frame's K1 on the same rays (graph replays: K1i, K1, K1,
    # K1i), beside the bound from bvh.traversal_work's two-level oracle (the
    # answers the plain version's), the plain version, the rows each reads
    # (their own stats) and the stepper loop's recorded time at this launch
    leaves_i = fi["meta"].bvh_leaves
    targets_i = {"bvh_closest_hit_inst": 0.55, "bvh_any_hit_inst": 0.40}
    for any_hit, name in ((False, "bvh_closest_hit_inst"), (True, "bvh_any_hit_inst")):
        (rows_, nint_, ninst_, depth_, iterb_, o_, d_, t_, *_), _, _ = first(
            "cornell_instanced", name)
        args_ = (rows_, nint_, ninst_, depth_, iterb_)
        flat_ = (s_ff.bvh_rows, m_ff.bvh_nint, m_ff.bvh_depth)
        R_ = o_.shape[0]
        if any_hit:
            (occ_, ms_plain), n_tie, err = compare_inst_any(args_, leaves_i, o_, d_, t_), 0, 0.0
            n_live, t_lim = int(occ_.sum()), t_
        else:
            n_live, _, n_tie, t_lim, err, ms_plain = compare_inst(args_, leaves_i, o_, d_, t_)
            occ_ = None
        tk, pk, ik = bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit)
        tf_, pf_ = bvh.traverse_cuda(*flat_, o_, d_, t_, any_hit)
        agree = float(((pk >= 0) == (pf_ >= 0)).float().mean())
        require(agree >= 0.9999, name, "against K1 on the flattened frame", agree)
        work = torch.zeros(5, dtype=torch.int64, device=dev)
        bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit, stats=work)
        work_f = torch.zeros(4, dtype=torch.int64, device=dev)
        bvh.traverse_cuda(*flat_, o_, d_, t_, any_hit, stats=work_f)
        own, own_f = tuple(int(x) for x in work.cpu()), tuple(int(x) for x in work_f.cpu())
        oracle = bvh.traversal_work(rows_, nint_, o_, d_, t_lim, occ_, (
            SLAB_VISIT_OPS, TRI_EDGE_OPS, TRI_RANGE_OPS, TRI_BOUND_OPS, INST_ENTRY_OPS),
            n_inst=ninst_)
        fns = {"k1i": lambda: bvh.traverse_inst_cuda(*args_, o_, d_, t_, any_hit),
               "k1": lambda: bvh.traverse_cuda(*flat_, o_, d_, t_, any_hit)}
        turns = {"k1i": [], "k1": []}
        for key in ("k1i", "k1", "k1", "k1i"):
            turns[key].append(graph_ms(fns[key]))
        ms, ms_f = (sum(turns[k]) / 2 for k in ("k1i", "k1"))
        call = events_ms(fns["k1i"], 20)
        b = bound(rows_.numel() * 4 + R_ * 7 * 4 + R_ * (4 if any_hit else 12),
                  oracle[0] * SLAB_VISIT_OPS + tri_test_ops(*oracle[1:4])
                  + oracle[4] * INST_ENTRY_OPS)
        old = K1I_OLD_LOOP_MS[name]
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=err, twin_k1_ms=ms_f, turns=turns,
                            host_paced_ms=call, oracle_work=oracle, kernel_stats=own,
                            twin_stats=own_f)
        log(f"{name} at the main path's launch ({R_} lanes, {n_live} "
            f"{'occluded' if any_hit else 'hits'}, {int((ik >= 0).sum())} in instances): against "
            f"its plain version on these arguments "
            f"{'the bits equal' if any_hit else f'bit-exact but on {n_tie} verified ties'}, max "
            f"abs err of t {err:.3e}; kernel {turns['k1i']} ms (host-paced {call:.4f} ms), the "
            f"flattened frame's {'K1a' if any_hit else 'K1'} on the same rays {turns['k1']} ms "
            f"in turns ({ms / ms_f:.3f}x it; hit masks equal on {agree:.6%}); the stepper loop "
            f"K1i ran on before its redesign, recorded at this launch of the levels (6, 5) frame: "
            f"{old} ms; plain {ms_plain:.1f} ms; oracle work (rows, tri "
            f"tests, past edge, past range, instance entries) {oracle}, bound {b[0]:.4f} ms "
            f"({b[1]}), kernel {ms / b[0]:.1f}x it; own stats {own}, the twin's {own_f} (rows "
            f"read {own[0] / own_f[0]:.2f}x the twin's); targets <= {targets_i[name]} ms (set "
            f"at levels (6, 5)) {'met' if ms <= targets_i[name] else 'missed'}, <= 1.3x the twin's "
            f"{'met' if ms <= 1.3 * ms_f else 'missed'}")
    # the refit of K1i's winners at the instanced frame's first closest-hit
    # launch, the object rays of instanced winners formed in the kernel:
    # bit-exact with its plain version (JAX's _refit_ray, a where)
    args_r = first("cornell_instanced", "bvh_refit")[0]
    out_k, out_p = bvh.refit_cuda(*args_r), bvh.refit_plain(*args_r)
    require(all(torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                            b.view(torch.int32) if b.dtype == torch.float32 else b)
                for a, b in zip(out_k, out_p)), "bvh_refit differs from its plain version on "
            "the instanced frame")
    log(f"bvh_refit at cornell-instanced's first closest-hit launch ({args_r[3].shape[0]} lanes, "
        f"{int((args_r[7] >= 0).sum())} instanced winners): bit-exact with its plain version")
    del inst_frame, fi, ff, s_ff, s_fa

    ov = int(bvh.overflow_counter(dev).item()) - ov0
    require(ov == 0, "traversal overflow lanes", ov)
    log("traversal overflow counter: 0")

    phase_start("13")
    # ---- 13. participating media on volumetric-caustic (homogeneous fog as
    # the camera's and the spot light's medium, the spot beam through a glass
    # ball): small renders on the card against the CPU; then the scene through
    # render() with BDPT at the bench's 128^2 x 8, the path integrator at its
    # file's 128^2 x 16 and its file's MLT over BDPT (128^2, max depth 7),
    # cut in mutations per pixel; K6t, the VOLUMETRIC K6 kernels and K12's
    # MEDIA instantiations against their plain versions on those frames'
    # captured launches, graph-timed beside their bounds
    import medium_cases
    for integ, spp_s in (("path", 2), ("bdpt", 1)):
        b_s = bd.SceneBuilder().parse_file(str(medium_cases.CAUSTIC))
        b_s.film["xresolution"] = b_s.film["yresolution"] = 16
        b_s.integrator["maxdepth"] = 3
        b_s.filter = {"type": "box"}
        imgs_s, rays_s = [], []
        for d_ in (dev, torch.device("cpu")):
            sc_s, mt_s = compile_scene(b_s, spp_s, device=d_, integrator_override=integ)
            img_s, st_s = rd.render(sc_s, mt_s, device=d_, return_stats=True)
            imgs_s.append(img_s.cpu().numpy())
            rays_s.append(st_s["closest"] + st_s["shadow"])
        check_image(blocks(imgs_s[0], 4), blocks(imgs_s[1], 4),
                    f"volumetric-caustic {integ} 16^2 card vs cpu (4x4 block means)")
        require(abs(rays_s[0] - rays_s[1]) <= 1e-3 * rays_s[1], "volumetric-caustic", integ,
                "rays card vs cpu", rays_s)
        log(f"small render volumetric-caustic {integ} 16^2 x {spp_s}, max depth 3, card vs cpu: "
            f"4x4 block means within tests/test_parity.py's criterion, means "
            f"{imgs_s[0].mean():.5f} / {imgs_s[1].mean():.5f}, rays {rays_s[0]} / {rays_s[1]}")
    vc = str(medium_cases.CAUSTIC)
    s_vb, m_vb = load_scene(vc, device=dev, spp=8, integrator="bdpt")
    s_vp, m_vp = load_scene(vc, device=dev, integrator="path")
    s_vm, m_vm = load_scene(vc, device=dev)
    require((m_vb.resolution, m_vb.spp, m_vp.spp, m_vm.integrator, m_vm.max_depth,
             m_vm.mutations_per_pixel, mlt.bdpt_dims(m_vm), m_vp.volumetric) ==
            ((128, 128), 8, 16, "mlt", 7, 100, 376, True), "volumetric-caustic settings")
    VOL_MUT = 8
    log(f"volumetric-caustic MLT frame at full width (128^2, max depth 7, 8192 chains, "
        f"{mlt.bdpt_dims(m_vm)} primary samples a chain) cut from 100 mutations per pixel "
        f"(200 passes) to {VOL_MUT} ({VOL_MUT * 128 * 128 // mlt.N_CHAINS} passes) so that "
        f"this phase fits the script's time; python -m pbrt_tpu_torch.profile_render renders "
        f"it uncut")
    vol_tri = ("dense_tri_closest", "dense_spheres", "transmit_hop")
    full_render("vol_bdpt", s_vb, m_vb, vol_tri + ("bdpt_connect_rays", "bdpt_connect_weight",
                                                   "film_add_samples", "film_add_splats"))
    full_render("vol_path", s_vp, m_vp, vol_tri + ("path_rr", "film_add_samples") + K6V[:3])
    full_render("vol_mlt", s_vm, dataclasses.replace(m_vm, mutations_per_pixel=VOL_MUT),
                vol_tri + ("bdpt_connect_rays", "bdpt_connect_weight", "mlt_mutate",
                           "mlt_accept_splat"))
    log(f"volumetric-caustic image means: BDPT {frame_means['vol_bdpt']:.5f}, path "
        f"{frame_means['vol_path']:.5f} (no caustic: a specular chain cannot reach the delta "
        f"spot light from the camera), MLT {frame_means['vol_mlt']:.5f} "
        f"({frame_means['vol_mlt'] / frame_means['vol_bdpt'] - 1:+.2%} of BDPT's)")
    require(frame_means["vol_mlt"] > 0 and frame_means["vol_bdpt"] > 0, "volumetric-caustic "
            "frames carry no light")

    def vol_bits(a, b):
        return all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                               y.view(torch.int32) if y.dtype == torch.float32 else y)
                   for x, y in zip(a, b))

    # K6t: bit-exact with transmit_hop_plain at the path frame's and the BDPT
    # frame's first launches; timed at the BDPT one (its n_ray R lanes),
    # each call from the same inputs (restored by copies, whose time is
    # taken out)
    hop_err = 0.0
    for tag in ("vol_path", "vol_bdpt"):
        sc_h, hit_h, o_h, d_h, p1_h, m_h, lam_h, tr_h, dn_h = first(tag, "transmit_hop")[0]
        want = pth.transmit_hop_plain(sc_h, hit_h, o_h, d_h, p1_h, m_h, lam_h, tr_h, dn_h)
        got = pth.transmit_hop_cuda(sc_h, hit_h, o_h.clone(), d_h, p1_h, m_h.clone(), lam_h,
                                    tr_h.clone(), dn_h.clone())
        require(vol_bits(got, want), tag, "K6t differs from transmit_hop_plain")
        live = ~dn_h
        n_l = int(live.sum())
        n_if = int((live & hit_h.valid & (hit_h.mat < 0)).sum())
        log(f"transmit_hop at {tag}'s first launch ({o_h.shape[0]} lanes, {n_l} live, "
            f"{int((live & hit_h.valid).sum())} of them with a hit, {n_if} crossing an "
            f"interface): bit-exact with its plain version")
    R_h = o_h.shape[0]
    o_w, m_w, tr_w, dn_w = o_h.clone(), m_h.clone(), tr_h.clone(), dn_h.clone()

    def restore():
        o_w.copy_(o_h)
        m_w.copy_(m_h)
        tr_w.copy_(tr_h)
        dn_w.copy_(dn_h)

    ms_c = graph_ms(restore)
    ms_t = graph_ms(lambda: (restore(), pth.transmit_hop_cuda(sc_h, hit_h, o_w, d_h, p1_h, m_w,
                                                               lam_h, tr_w, dn_w)))
    ms_hop = ms_t - ms_c
    ms_plain = events_ms(lambda: pth.transmit_hop_plain(sc_h, hit_h, o_h, d_h, p1_h, m_h, lam_h,
                                                        tr_h, dn_h), 3)
    # bytes: every lane its done flag in and t_max out; a live lane its
    # origin, end, medium, hit flag, wavelengths and transmittance in and
    # the transmittance out; a live lane with a hit its t and material; an
    # interface lane the hit point, normal, direction and media in, its
    # origin and medium out; a lane done at this hop its flag out; the
    # sigma rows once
    live_hit = live & hit_h.valid
    n_lv = int(live_hit.sum())
    n_end = n_l - n_if
    hop_b = (R_h * (1 + 4) + n_l * (12 + 12 + 8 + 1 + 16 + 32) + n_lv * (4 + 8)
             + n_if * (36 + 16 + 20) + n_end + 2 * sc_h.med_sigma_a.numel() * 4)
    b = bound(hop_b, n_l * VOL_OPS["hop"] + R_h * VOL_OPS["hop_lane"])
    timing["transmit_hop"] = dict(ms=ms_hop, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                                  library_ms=None, max_abs_err=hop_err, restore_ms=ms_c,
                                  lanes=R_h, live=n_l, interface=n_if)
    log(f"transmit_hop at vol_bdpt's first launch ({R_h} lanes): kernel {ms_hop:.4f} ms "
        f"({ms_t:.4f} with the inputs' restore, which alone takes {ms_c:.4f}), plain "
        f"{ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}: {hop_b} bytes), {ms_hop / b[0]:.1f}x "
        f"it; {pth.MAX_HOPS} launches a transmittance")

    # the VOLUMETRIC K6 kernels at the path frame's first and third bounces:
    # the draws, masks, medium and depth bit-exact with the plain parts, the
    # floats to tests/path_cases.py's criteria; timed at the first, each
    # alone
    vol_err = dict.fromkeys(K6V[:3], 0.0)
    for nth in ("", "#3"):
        args_v = first("vol_path", "path_shade_vol" + nth)[0]
        sc_v, mt_v, st_v, hit_v = args_v[:4]
        (sp, shp, pp, _), (sk, shk, pk, _) = (pth.shade_vol_plain(*args_v),
                                              pth.shade_vol_cuda(*args_v))
        rep_v = path_cases.Report()
        path_cases.compare_state(rep_v, sk, sp, path_cases.STATE_FLOATS + ("trans_pdf",))
        exact = {k: torch.equal(getattr(sk, k), getattr(sp, k))
                 for k in ("active", "specular", "depth", "medium")}
        exact.update(smp=torch.equal(sk.smp.state, sp.smp.state)
                     and torch.equal(sk.smp.dim, sp.smp.dim), nee=torch.equal(pk.mask, pp.mask))
        require(rep_v.ok() and all(exact.values()), "VOLUMETRIC K6 against the plain parts at "
                f"vol_path's bounce {nth or '#1'}", exact, str(rep_v))
        m_ = pp.mask
        trans_v = pth.transmittance(sc_v, mt_v, shp.o, shp.d, shp.p, shp.medium, sp.lam,
                                    shp.t_max)
        rp, rk = pth.resolve_vol_plain(sp, pp, trans_v), pth.resolve_vol_cuda(sp, pp, trans_v)
        rep_r = path_cases.Report()
        rep_r.near("L", rk.L, rp.L)
        require(rep_r.ok() and int(rk.n_shadow) == int(rp.n_shadow), "path_resolve_vol",
                str(rep_r))
        # each kernel's own outputs: path_shade_vol's L, path_bsdf_vol's beta
        # and transmittance pdf, path_resolve_vol's L
        for name, rep_, fields in (("path_shade_vol", rep_v, ("L",)),
                                   ("path_bsdf_vol", rep_v, ("beta", "trans_pdf")),
                                   ("path_resolve_vol", rep_r, ("L",))):
            vol_err[name] = max(vol_err[name], *(rep_.max_abs[f] for f in fields))
        scat = int((sp.active & (sp.medium >= 0) & (sp.prev_ns == 0).all(-1)).sum())
        log(f"path_shade_vol, path_bsdf_vol, path_resolve_vol at vol_path's bounce {nth or '#1'} "
            f"({st_v.o.shape[0]} lanes, {int(m_.sum())} with NEE, ~{scat} scattered in the fog): "
            f"draws, masks, medium and depth bit-exact {exact}; {rep_v.worst()}; shadow segments' "
            f"media equal on the NEE lanes: {torch.equal(shk.medium[m_], shp.medium[m_])}")
    args_v = first("vol_path", "path_shade_vol")[0]
    sc_v, mt_v, st_v, hit_v = args_v[:4]
    R_v = st_v.o.shape[0]
    n_hit = int((st_v.active & hit_v.valid).sum())
    n_med = int((st_v.active & (st_v.medium >= 0)).sum())
    shade_b = R_v * (187 + 149) + n_hit * 56
    bsdf_b = R_v * (127 + 86) + n_hit * 64
    res_args = first("vol_path", "path_resolve_vol")[0]
    n_nee = int(res_args[1].mask.sum())
    res_b = R_v * (17 + 16) + n_nee * 56 + 16
    for name, fn, plain, nb, ops in (
            ("path_shade_vol", lambda: pth.shade_vol_cuda(*args_v, kernels=("path_shade_vol",)),
             lambda: pth.shade_light_vol_plain(*args_v), shade_b,
             n_hit * K6_OPS["shade"] + n_med * VOL_OPS["event"]),
            ("path_bsdf_vol", lambda: pth.shade_vol_cuda(*args_v, kernels=("path_bsdf_vol",)),
             lambda: pth.shade_bsdf_vol_plain(*args_v), bsdf_b,
             n_hit * K6_OPS["shade_bsdf"] + n_med * VOL_OPS["event"]),
            ("path_resolve_vol", lambda: pth.resolve_vol_cuda(*res_args),
             lambda: pth.resolve_vol_plain(*res_args), res_b, n_nee * VOL_OPS["resolve"])):
        ms, call = kernel_ms(fn)
        ms_plain = events_ms(plain, 3)
        b = bound(nb, ops)
        timing[name] = dict(ms=ms, plain_ms=ms_plain, bound_ms=b[0], bound_by=b[1],
                            library_ms=None, max_abs_err=vol_err[name], host_paced_ms=call,
                            bytes=nb, ops=ops)
        log(f"{name} at vol_path's first bounce ({R_v} lanes, {n_hit} hits, {n_med} in the fog, "
            f"{n_nee} NEE): kernel {ms:.4f} ms (host-paced {call:.4f} ms), plain "
            f"{ms_plain:.3f} ms, bound {b[0]:.5f} ms ({b[1]}: {nb} bytes, {ops} ops), "
            f"{ms / b[0]:.1f}x it; max abs err of its own outputs over bounces #1 and #3 "
            f"{vol_err[name]:.3e}")

    # K12's MEDIA instantiations on the BDPT frame's first wave: the
    # segments bit-exact with connect_segments_plain, the whole stage with
    # the transmittance loop against connect_all_plain (tests/bdpt_cases.py's
    # criterion); then both entry points timed beside their bounds
    wave_v = first("vol_bdpt", "bdpt_wave")[0]
    # the captured pointer table names the frame's own (freed) tensors: a new
    # one over the kept copies
    ft_v = bdpt.field_table(wave_v[3], wave_v[2], wave_v[5], bdpt.contiguous_samples(wave_v[6]))
    a_seg = (wave_v[0], ft_v, bdpt.strategy_table(wave_v[5], dev))
    got_s = bdpt.connect_segments_cuda(*a_seg)
    want_s = bdpt.connect_segments_plain(*wave_v[:1], *wave_v[2:4], *wave_v[5:7])
    require(vol_bits([x.reshape(-1) for x in got_s], [y.reshape(-1) for y in want_s[1:]]),
            "K12 MEDIA segments differ from connect_segments_plain")
    res_v = bdpt_cases.compare(*wave_v)
    bdpt_cases.require_agreement(res_v)
    n_med_v = sum(int((v.vtype == bdpt.VT_MEDIUM).sum()) for v in wave_v[2] + wave_v[3])
    log(f"K12 MEDIA on vol_bdpt's wave ({res_v['lanes']} lanes x {res_v['strategies']} "
        f"strategies, {n_med_v} medium vertices): segments bit-exact with the plain version; "
        f"against plain, worst strategy {res_v['worst']} agrees on {res_v['frac']:.6%} of its "
        f"live lanes, L {res_v['L_frac']:.6%}; rays {res_v['rays_kernel']} = plain "
        f"{res_v['rays_plain']}; max abs err {res_v['max_abs_err']:.3e}")
    for name, t in k12_times("vol_bdpt's wave (MEDIA)", wave_v, a_seg,
                             a_seg + tuple(first("vol_bdpt", "bdpt_connect_weight")[0][3:]),
                             5).items():
        timing[name]["volumetric"] = dict(t, max_abs_err=res_v["max_abs_err"])

    phase_start("14")
    # ---- 14. textures, mix and named materials (K13, csrc/texture.cu): K13
    # against its plain version on tests/texture_cases.py's synthetic lanes
    # (every node type, mapping, wrap mode, image format, textured slot and a
    # mix) with and without footprints; then the full-width textured
    # cornell-mesh through render() with the path integrator (256^2 x 16,
    # depth 5), BDPT (the bench's cornell-bdpt 128^2 x 8) and mltpath (256^2,
    # cut to 8 passes), K13 once a bounce or walk step; rows of the path frame
    # against the CPU; K13 and the shading kernels on the path frame's first
    # bounce against their plain versions; K13 graph-timed there beside its
    # bound, and at each walk launch of the BDPT frame's wave
    import texture_cases
    tex_dir = kernels.BUILD_DIR / "textures"
    b_tc = bd.SceneBuilder()
    b_tc.parse_tokens(lx.tokenize(texture_cases.scene_text(tex_dir / "cases")))
    s_tc, m_tc = compile_scene(b_tc, device=dev)
    require(m_tc.textured, "texture_cases' scene is not textured")
    tex_err = 0.0
    for fp in (False, True):
        L = texture_cases.synthetic_lanes(s_tc, 1 << 17, 11, fp, dev)
        a_t = (s_tc, L["lanes"], L["mat"], L["p"], L["wo"], L["uv"], L["ns"], L["lam"],
               L["duv"])
        res_t = texture_cases.compare(texlib.eval_lanes_cuda(*a_t), texlib.eval_lanes_plain(*a_t))
        require(texture_cases.agree(res_t), "K13 against its plain version on synthetic lanes",
                "with" if fp else "without", "footprints", res_t)
        tex_err = max(tex_err, res_t["max_abs"])
        log(f"tex_eval on texture_cases' {1 << 17} synthetic lanes "
            f"({'with' if fp else 'without'} footprints; {s_tc.tex.type.shape[0]} nodes, every "
            f"node type, mapping, wrap mode and textured slot, a mix): materials and slot masks "
            f"bit-exact; {res_t['slots']} slot values, {res_t['frac_far']:.3e} of them beyond "
            f"{texture_cases.TEX_ATOL}, max abs err {res_t['max_abs']:.3e}")
    s_tp, m_tp = compile_scene(ts.textured_cornell_mesh_builder(image_dir=tex_dir), device=dev)
    s_tb, m_tb = compile_scene(ts.textured_cornell_mesh_builder(image_dir=tex_dir, res=128,
                                                                spp=8), device=dev,
                               integrator_override="bdpt")
    s_tm, m_tm = compile_scene(ts.textured_cornell_mesh_builder(image_dir=tex_dir), device=dev,
                               integrator_override="mltpath")
    require((m_tp.n_tris, m_tp.resolution, m_tp.spp, m_tp.max_depth, m_tb.resolution, m_tb.spp,
             m_tp.textured) == (16396, (256, 256), 16, 5, (128, 128), 8, True),
            "textured cornell-mesh settings")
    tex_k6 = ("path_rr", "path_shade", "path_bsdf", "path_resolve")
    full_render("tex_path", s_tp, m_tp, ("bvh_closest_hit", "bvh_any_hit", "film_add_samples",
                                         "tex_eval") + tex_k6)
    full_render("tex_bdpt", s_tb, m_tb, ("bvh_closest_hit", "bdpt_connect_rays",
                                         "bdpt_connect_weight", "film_add_splats", "tex_eval"))
    full_render("tex_mlt", s_tm, dataclasses.replace(m_tm, mutations_per_pixel=1),
                ("tex_eval", "mlt_mutate", "mlt_accept_splat") + tex_k6)

    # the path frame against the CPU on its own lanes: image rows 192-207
    # (across both balls) of the 256^2 x 16 frame rendered on the CPU through
    # render_batched, the same (pixel, sample) lanes and so the same random
    # numbers, held to tests/test_parity.py's criterion on 4x4 block means
    # (256 samples a block) and the rows' mean: the mix hashes the bits of the
    # hit point and wo, so a path whose bounce the kernels round an ulp apart
    # from the plain step may pick the other material there and go on
    # independently (with the mix ball made its diffuse, the card's and the
    # CPU's frames agree per pixel: test_torch_gpu.py::
    # test_textured_renders_on_card_match_cpu)
    band = range(192, 208)
    cpu = torch.device("cpu")
    t_band = time.time()
    s_rc, m_rc = compile_scene(ts.textured_cornell_mesh_builder(image_dir=tex_dir), device=cpu)
    w_rc = m_rc.resolution[0]
    film_rc = filmlib.new_film(m_rc.resolution, cpu)
    st_rc = rd.render_batched(s_rc, m_rc, film_rc, pix0=band.start * w_rc,
                              n_pix=len(band) * w_rc)
    r_cpu = filmlib.develop(film_rc, m_rc.resolution, out_matrix=m_rc.film_out_matrix,
                            imaging_ratio=m_rc.film_imaging_ratio)[band.start:band.stop].numpy()
    t_band = time.time() - t_band
    st_rg = rd.render_batched(s_tp, m_tp, filmlib.new_film(m_tp.resolution, dev),
                              pix0=band.start * w_rc, n_pix=len(band) * w_rc)
    n_rc, n_rg = (int(x["closest"] + x["shadow"]) for x in (st_rc, st_rg))
    r_card = frame_imgs["tex_path"][band.start:band.stop]
    px_bad = float((np.abs(r_card - r_cpu) > 5e-3 + 0.05 * np.abs(r_cpu)).mean())
    check_image(blocks(r_card, 4), blocks(r_cpu, 4), "textured cornell-mesh rows 192-207 card vs "
                "cpu (4x4 block means)")
    require(abs(n_rg - n_rc) <= 1e-2 * n_rc, "textured rows' rays card vs cpu", n_rg, n_rc)
    log(f"textured cornell-mesh 256^2 x 16 rows {band.start}-{band.stop - 1}, the path frame's "
        f"against those rows' lanes on the cpu ({t_band:.1f} s): 4x4 block means and the mean "
        f"within tests/test_parity.py's criterion ({px_bad:.3%} of values outside it per pixel: "
        f"the mix), means {r_card.mean():.5f} / {r_cpu.mean():.5f}, rays card / cpu "
        f"{n_rg} / {n_rc}")
    # the means' noise: card frames of the scene at 32^2 x 16 (16,384
    # samples, the frame the path frame was first held to), 32^2 x 1024 (the path frame's
    # 2^20) under a box filter and 256^2 x 16 under a box filter
    noise = {}
    for res_, spp_ in ((32, 16), (32, 1024), (256, 16)):
        b_n = ts.textured_cornell_mesh_builder(image_dir=tex_dir, res=res_, spp=spp_)
        b_n.filter = {"type": "box"}
        noise[res_, spp_] = float(rd.render(*compile_scene(b_n, device=dev)).mean())
    log(f"textured cornell-mesh image means: path {frame_means['tex_path']:.5f}, BDPT "
        f"{frame_means['tex_bdpt']:.5f}, mltpath {frame_means['tex_mlt']:.5f}; card frames "
        f"under a box filter: 32^2 x 16 {noise[32, 16]:.5f}, 32^2 x 1024 {noise[32, 1024]:.5f}, "
        f"256^2 x 16 {noise[256, 16]:.5f} (the path frame "
        f"{frame_means['tex_path'] / noise[32, 16] - 1:+.2%} of the first, "
        f"{frame_means['tex_path'] / noise[32, 1024] - 1:+.2%} of the second, "
        f"{frame_means['tex_path'] / noise[256, 16] - 1:+.2%} of the third)")
    for tag in ("tex_bdpt", "tex_mlt"):
        require(abs(frame_means[tag] / frame_means["tex_path"] - 1) < 0.1, tag,
                "image mean against the path frame's", frame_means[tag])
    # K13 on the path frame's first bounce: against its plain version, then
    # graph-timed beside its bound (tests/texture_cases.tex_work) and plain
    a_k = first("tex_path", "tex_eval")[0]
    res_k = texture_cases.compare(texlib.eval_lanes_cuda(*a_k), texlib.eval_lanes_plain(*a_k))
    require(texture_cases.agree(res_k), "K13 against its plain version on tex_path's first "
            "bounce", res_k)
    tex_err = max(tex_err, res_k["max_abs"])
    out_k = texlib.eval_lanes_plain(*a_k)
    nb_k, ops_k = texture_cases.tex_work(a_k[0], a_k[1], a_k[2], out_k, a_k[5], a_k[3],
                                         a_k[8])
    ms_k, call_k = kernel_ms(lambda: texlib.eval_lanes_cuda(*a_k))
    ms_kp = events_ms(lambda: texlib.eval_lanes_plain(*a_k), 3)
    b_k = bound(nb_k, ops_k)
    n_lanes, n_ev = a_k[2].shape[0], int(a_k[1].sum())
    # K13 in BDPT's walk: each of the tex_bdpt wave's 2 max_depth + 1 walk
    # launches (camera walk, then light walk) against its plain version,
    # graph-timed and summed beside their summed bounds and plain times
    walk = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, launches=2 * m_tb.max_depth + 1,
                evaluated=0, slots=0, frac_far=0.0)
    for n in range(1, walk["launches"] + 1):
        a_w = first("tex_bdpt", "tex_eval" if n == 1 else f"tex_eval#{n}")[0]
        out_w = texlib.eval_lanes_plain(*a_w)
        res_w = texture_cases.compare(texlib.eval_lanes_cuda(*a_w), out_w)
        require(texture_cases.agree(res_w), "K13 against its plain version at tex_bdpt's walk "
                "launch", n, res_w)
        tex_err = max(tex_err, res_w["max_abs"])
        walk["ms"] += graph_ms(lambda: texlib.eval_lanes_cuda(*a_w))
        walk["plain_ms"] += events_ms(lambda: texlib.eval_lanes_plain(*a_w), 1)
        walk["bound_ms"] += bound(*texture_cases.tex_work(a_w[0], a_w[1], a_w[2], out_w, a_w[5],
                                                          a_w[3], a_w[8]))[0]
        walk["evaluated"] += int(a_w[1].sum())
        walk["frac_far"] = max(walk["frac_far"], res_w["frac_far"])
        walk["slots"] += res_w["slots"]
    log(f"tex_eval in tex_bdpt's walk ({walk['launches']} launches of "
        f"{first('tex_bdpt', 'tex_eval')[0][2].shape[0]} lanes, {walk['evaluated']} evaluated): "
        f"each against its plain version, materials and masks bit-exact, at most "
        f"{walk['frac_far']:.3e} of a launch's slot values beyond {texture_cases.TEX_ATOL}; "
        f"kernel {walk['ms']:.4f} ms summed, bound {walk['bound_ms']:.5f}, plain "
        f"{walk['plain_ms']:.3f} ms; launches a frame {frame_counts['tex_bdpt']['tex_eval']}, "
        f"{walk['ms'] / frame_walls['tex_bdpt'] / 10:.4f} % of the frame's wall")
    timing["tex_eval"] = dict(ms=ms_k, plain_ms=ms_kp, bound_ms=b_k[0], bound_by=b_k[1],
                              library_ms=None, max_abs_err=tex_err, host_paced_ms=call_k,
                              lanes=n_lanes, evaluated=n_ev, bytes=nb_k, ops=ops_k,
                              bdpt_walk=walk)
    log(f"tex_eval at tex_path's first bounce ({n_lanes} lanes, {n_ev} evaluated, "
        f"{int((out_k.mat != a_k[2]).sum())} resolved from a mix): materials and masks "
        f"bit-exact, {res_k['frac_far']:.3e} of {res_k['slots']} slot values beyond "
        f"{texture_cases.TEX_ATOL}; kernel {ms_k:.4f} ms (host-paced {call_k:.4f}), plain "
        f"{ms_kp:.3f} ms, bound {b_k[0]:.5f} ms ({b_k[1]}: {nb_k} bytes, {ops_k} ops), "
        f"{ms_k / b_k[0]:.1f}x it; launches a frame {main_counts['tex_eval']}")
    # the shading kernels on that bounce (reading K13's overrides) against
    # the plain parts, path_cases' criteria (draws and masks bit-exact)
    args_s = first("tex_path", "path_shade")[0]
    rep_s = path_cases.compare_shade(args_s, pth.shade_cuda, pth.shade_plain)
    require(rep_s.ok(), "path_shade and path_bsdf on tex_path's first bounce against "
            "shade_plain", str(rep_s))
    log(f"path_shade and path_bsdf on tex_path's first bounce (K13's overrides) against "
        f"shade_plain (the plain K13): {rep_s.worst()}")

    phase_start("15")
    # ---- 15. kernels line and result
    meta_k = {
        "bvh_closest_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                            "pbrt_tpu/accel/bvh.py:909"),
        "bvh_any_hit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                        "pbrt_tpu/accel/bvh.py:1218"),
        "film_add_samples": ("cuda", "pbrt_tpu_torch/csrc/film.cu",
                             "pbrt_tpu/film/film.py:54"),
        "film_add_scatter": ("cuda", "pbrt_tpu_torch/csrc/film.cu",
                             "pbrt_tpu/film/film.py:44"),
        "dense_tri_closest": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                              "pbrt_tpu/geometry/intersect.py:224"),
        "dense_tri_any": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                          "pbrt_tpu/geometry/intersect.py:244"),
        "dense_spheres": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                          "pbrt_tpu/geometry/intersect.py:267"),
        "dense_spheres_any": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                              "pbrt_tpu/accel/dispatch.py:321"),
        "dense_disks": ("cuda", "pbrt_tpu_torch/csrc/dense_intersect.cu",
                        "pbrt_tpu/geometry/intersect.py:358"),
        "wavefront_recycle": ("cuda", "pbrt_tpu_torch/csrc/wavefront.cu",
                              "pbrt_tpu/integrators/render.py:228"),
        "layered_f": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                      "pbrt_tpu/materials/layered.py:82"),
        "layered_sample": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                           "pbrt_tpu/materials/layered.py:334"),
        "layered_pdf": ("cuda", "pbrt_tpu_torch/csrc/layered.cu",
                        "pbrt_tpu/materials/layered.py:475"),
        "film_add_splats": ("cuda", "pbrt_tpu_torch/csrc/film.cu",
                            "pbrt_tpu/film/film.py:70"),
        "bdpt_connect_rays": ("cuda", "pbrt_tpu_torch/csrc/bdpt.cu",
                              "pbrt_tpu/integrators/bdpt.py:731"),
        "bdpt_connect_weight": ("cuda", "pbrt_tpu_torch/csrc/bdpt.cu",
                                "pbrt_tpu/integrators/bdpt.py:608"),
        "mlt_mutate": ("cuda", "pbrt_tpu_torch/csrc/mlt.cu", "pbrt_tpu/integrators/mlt.py:53"),
        "mlt_accept_splat": ("cuda", "pbrt_tpu_torch/csrc/mlt.cu",
                             "pbrt_tpu/integrators/mlt.py:106"),
        "bvh_closest_hit_parts": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                                  "pbrt_tpu/parallel/scene_shard.py:226"),
        "bvh_any_hit_parts": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                              "pbrt_tpu/parallel/scene_shard.py:256"),
        "shard_select": ("cuda", "pbrt_tpu_torch/csrc/scene_shard.cu",
                         "pbrt_tpu/parallel/scene_shard.py:226"),
        "bvh_closest_hit_inst": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                                 "pbrt_tpu/accel/bvh.py:794"),
        "bvh_any_hit_inst": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                             "pbrt_tpu/accel/bvh.py:794"),
        "bvh_refit": ("cuda", "pbrt_tpu_torch/csrc/bvh_traverse.cu",
                      "pbrt_tpu/accel/bvh.py:1193"),
        "path_rr": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                    "pbrt_tpu/integrators/path.py:193"),
        "path_shade": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                       "pbrt_tpu/integrators/path.py:193"),
        "path_bsdf": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                      "pbrt_tpu/integrators/path.py:193"),
        "path_coat": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                      "pbrt_tpu/integrators/path.py:193"),
        "path_resolve": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                         "pbrt_tpu/integrators/path.py:193"),
        "path_shade_vol": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                           "pbrt_tpu/integrators/path.py:193"),
        "path_bsdf_vol": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                          "pbrt_tpu/integrators/path.py:193"),
        "path_resolve_vol": ("cuda", "pbrt_tpu_torch/csrc/path_step.cu",
                             "pbrt_tpu/integrators/path.py:193"),
        "transmit_hop": ("cuda", "pbrt_tpu_torch/csrc/transmit.cu",
                         "pbrt_tpu/integrators/path.py:98"),
        "tex_eval": ("cuda", "pbrt_tpu_torch/csrc/texture.cu",
                     "pbrt_tpu/textures/textures.py:370"),
    }
    kern = [dict(name=name, route=route, source=src, replaces=rep, launches=main_counts[name],
                 **timing[name], ok=True)
            for name, (route, src, rep) in meta_k.items()]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kern}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
