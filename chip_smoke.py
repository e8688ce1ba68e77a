"""Smoke run of the PyTorch port's main paths on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``magcache_tpu_torch`` (never JAX) in eighty-nine phases and exits
nonzero on the first failure:

1. environment: a CUDA card is required; prints the card's name and power
   limit (nvidia-smi) and turns TF32 off for f32 matmuls and convolutions;
2. build: compiles the CUDA library (nvcc, sm_90a, one process per source)
   and the Triton kernels from the sources in this checkout;

Wan2.1 T2V-1.3B (K1, K2, K3, and K3p in the head):
3. each kernel against its plain PyTorch version at the path's shapes
   (832x480x81: 32,760 tokens, 2 CFG lanes, bf16), with the tolerance
   stated, and both times; K1 (the warp-specialised wgmma/TMA body of
   ``csrc/hopper_attention.cuh``, 128-row tiles) also at phase 5's
   7,800-token request shape, whose last query and key tiles are ragged;
4. one full-shape forward (prepare -> trunk -> head) of WAN_1_3B;
5. requests through ``WanPipeline.generate`` at full width, 832x480x17
   (7,800 tokens): full compute, MagCache E012K2R02, and the same schedule
   with lane-asymmetric steps (the half-batch partial trunk). Checks the
   realized skip bits against ``compute_skip_schedule`` and each kernel's
   launch count against the number of trunk runs;
6. the Wan slice on the card (kernels, bf16) against the CPU (plain ops,
   f32) at a narrow width with numpy weights;

Open-Sora 1.2 STDiT3-XL/2 (K3, K5, K6, K7, K8):
7. each kernel against its plain version at the path's shapes (480p 9:16,
   51 frames: 15 frames of 1,590 tokens, a joint CFG batch of 2, bf16);
   K7 (the LayerNorm-modulated operand, then the wgmma/TMA GEMM body of
   ``csrc/hopper_gemm.cuh``) beside cuBLAS on the already-modulated operand
   (a yardstick, not the same function), K6 (GEMM body,
   ``hopper_cross_kernel``, GEMM body) with its three launches also timed
   apart, K8 (the GEMM body with its gate epilogue, rows flattened) beside
   cuBLAS ``F.linear`` with bias (GEMM only) (phases 15 and 19 the same at
   their shapes); K5 spatial (the "prepass" route: the qk-norm pre-pass,
   then the wgmma/TMA body in the grouped geometry, fixed max) with its two
   launches also timed apart, and K5 spatial and temporal (the "stream"
   route) beside SDPA on the same q/k/v without the norm (not the same
   function);
8. one full-shape forward, 28 layers; checks the grouped launches by route
   per forward (prepass 28, stream 28; no "tiled" route any more);
9. requests through ``OpenSoraPipeline.generate`` at 480p x 51 frames and
   30 RFLOW steps: full compute, then MagCache opensora-v1.2 (18 of 30
   steps skipped); checks skip bits, launch counts and latents;
10. the Open-Sora slice on the card (bf16) against the CPU (f32) at hidden
   144, 2 heads of 72, 2 layers, over RFLOW steps with skipped ones;

FLUX.1-dev and FLUX.1-Kontext-dev (K1, K2 in head scope, K3):
11. each kernel against its plain version at the path's shapes (1024x1024:
   4,096 image + 512 text tokens, bf16): K2 head scope on strided q/k slices
   of the fused projections, K1 over the 4,608-token joint sequence, K3 mod;
12. one full-shape forward of FLUX.1-dev (19 double + 38 single blocks,
   12 B parameters) at 1024x1024, and one Kontext forward (8,704 tokens);
13. requests through ``FluxPipeline.generate`` at 1024x1024 and 28 Euler
   steps: full compute and MagCache flux-dev (19 of 28 steps skipped), then
   a Kontext pair with flux-kontext-dev (14 of 28); checks skip bits, launch
   counts and latents;
14. the FLUX slice on the card (bf16) against the CPU (f32) at hidden 256,
   2 heads of 128, 2 + 2 blocks, over Euler steps with skipped ones.

Open-Sora 1.2 at 720p and its mask-strategy conditioning (K1q, K3, K5-K8):
15. K1q (the per-head RMS qk-norm pre-pass, then K1's wgmma/TMA body at
   head dim 72 carried as 80, fixed max) against its plain version at one
   spatial block's 720p 9:16 shape: q/k/v read as column views of one
   [30, 3600, 3456] bf16 projection, bit-equal to contiguous copies, its
   two launches also timed apart; then K5
   (the "stream" route, with its TB/s and SDPA without the norm) and K3 at
   the temporal block's 720p shapes and K6, K7 and K8 at the 720p blocks'
   shapes;
16. one full-shape forward at 720p 9:16 x 51 frames (15 frames of 3,600
   tokens, 2 rows: 108,000 tokens), 28 layers, twice; grouped launches by
   route per forward: stream 28;
17. requests through ``OpenSoraPipeline.generate`` at 720p 9:16 x 17 frames
   (5 latent frames; frames cut from 51 so the phase stays short) and 30
   RFLOW steps: full compute, MagCache opensora-v1.2 (18 of 30 skipped), and
   one MagCache request with a mask strategy (latent frame 0 pinned to a
   seeded .npy reference, the last frame at edit ratio 0.5); checks skip
   bits, launch counts and latents;
18. the narrow slice on the card (bf16) against the CPU (f32) with frames of
   2,304 tokens (K1q): one plain request, and one with a pinned reference
   frame and ``loop=2`` (the masked blocks, the masked sampler, the loop
   hand-off).

Latte-1 T2V (K5r, K4, K9, K1 at padded head dim, K3, K6-K8):
19. each kernel against its plain version at 512x512 x 16 shapes (2 rows of
   16 frames x 1,024 tokens, bf16): K5r spatial (the row-max instantiation
   of the wgmma/TMA body) and temporal (the "stream" kernel), K5r at groups
   of 1,590 with 1,400 valid keys (ragged tiles, positions past
   group_valid), K4 and K9 at the temporal shape (and with gains and RoPE
   at the STDiT3 480p temporal shape; K9 on its "stream" route at both,
   logged with its rate in TB/s), K1 with the running max at head dim 72
   zero-padded to 128 (spatial and cross), K3, K6 over 120 caption keys, K7
   and K8;
20. one full-shape forward of LATTE_1 (28 block pairs, 1.057 B parameters)
   on each route: packed, grouped (K4) and vpu (K9), twice each; checks the
   launches per trunk run, the grouped launches by route (packed: tma
   28, stream 28; grouped: stream 28; vpu: none) and K9's (vpu: stream
   28);
21. requests through ``LattePipeline.generate`` at 512x512 x 16 and 50 DDIM
   steps: a full-compute calibration request, then MagCache (E 0.12 K 3
   R 0.2) with the recorded ratios installed, on the packed route and on the
   grouped route with the same skip mask; checks skip bits, launch counts
   and latents, and prints the two routes' rel L2;
22. the Latte slice on the card (bf16) against the CPU (f32) at hidden 144,
   2 heads of 72, 2 block pairs, 16 frames at 256x256 (256 tokens per
   frame), on the packed and grouped routes over DDIM steps with skipped
   ones; and one trunk forward on the same input, card against CPU, per
   route (the gap before the DDIM steps amplify it).

Wan2.1 T2V-1.3B sequence-parallel over ``sp`` = 4 (K1b, K1c, K2, K3, K3p).
The four ranks are threads of this process on the one card
(``parallel.mesh.run_local_ranks``); their work is serialised on it, so a
wall time here is no time of a four-GPU run:
23. each new kernel against its plain version at the sp = 4 shapes of
   832x480x81 (bf16): K1b (K1's wgmma/TMA body read through batch, head and
   token strides) at the Ulysses self shape [2, 3, 32760, 128] with the fixed and
   the running max and at the cross shape (8,190 queries, 512 keys, 12
   heads); K1c (the running max that returns each row's m and l) at the ring
   step shape [2, 12, 8190, 128]; the ring merge of 4 shards against K1 on
   the whole sequence; K3p (the affine-free LayerNorm) at 2 x 32,760 x 1536;
24. one full-shape forward of WAN_1_3B under 4 local ranks, Ulysses and then
   ring, each against phase 4's single-rank output; checks the launches per
   forward;
25. requests through ``WanPipeline.generate`` at 832x480x17 and 20 steps
   under 4 local ranks (1,950 tokens a rank): full compute and MagCache
   E012K2R02 with Ulysses, MagCache once with the ring; skip bits on every
   rank, launch counts, identical latents on every rank, and their distance
   from phase 5's single-rank latents;
26. the narrow Wan slice of phase 6 on the card (bf16) under 2 local ranks,
   Ulysses and ring, against the CPU (f32) on one rank.

Open-Sora 1.2 on STDiT3's unpacked routes and without qk-norm (K1 at head
dim 72 zero-padded to 128, K3, K4, K7, K9; K5r, K6-K8):
27. K1 as ``attention()`` runs it at STDiT3's unpacked shapes (spatial
   30x1590x16x72 with the fixed and the running max, 720p's 30x3600x16x72
   with the running max, cross 2x23,850 x 300 keys), each beside SDPA at
   head dim 72 and bounded at 72; K5r's "stream" route with RoPE and no
   norm at the 480p temporal shape (47,700 rows, groups of 15), as the
   packed route runs it without qk-norm; and K4 as the "grouped" route
   calls it (q and k normed and rotated by plain ops, groups of 15, the row
   max) beside SDPA on the same q/k/v, and the route's whole temporal call;
28. full-shape forwards at 480p 9:16 x 51 on the packed route (once) and on
   "grouped" and "vpu" (twice each), the same weights and inputs: launches
   per forward (K3 56, K1 84 of which 28 at the fixed max, K7 56, and K4 or
   K9 28 on its "stream" route), rel L2 against the packed output <= 5e-2;
29. a MagCache request on "grouped" at 480p x 51 frames and 30 RFLOW steps:
   skip bits and launches;
30. STDiT3-XL/2 with ``qk_norm=False``: forwards on "packed" and "grouped"
   at 480p and at 720p (frames of 3,600 tokens: packed runs K1 through
   ``attention()`` there), rel L2 <= 5e-2 between the two routes at each
   size; no fixed-max launch (K1, K1q, K5) on any.

Wan2.1 T2V-1.3B's ends (cuBLAS and cuDNN; TF32 off, as phase 1 sets it):
31. UMT5-XXL (5.68 B parameters, its config's f32) encoding the request's two
   prompts x 512 tokens through the hash tokenizer: init and encode times,
   peak memory; a narrow encoder on the card against the CPU (f32, <= 1e-4
   of the largest value);
32. the Wan2.1 VAE decoding seeded latents [1, 21, 60, 104, 16] to pixels
   [1, 81, 480, 832, 3], one latent frame a call, in f32 and in bf16: times
   and peak memory, bf16 within 5e-2 of f32 (of the largest pixel); on a
   narrow clip the card against the CPU and streamed against whole (f32,
   <= 1e-4 of the largest pixel);
33. one request through ``WanPipeline.generate`` at 832x480x17 and 20
   steps with phase 31's UMT5-XXL and phase 32's f32 VAE: pixels
   [1, 17, 480, 832, 3], launches, request and decode times.

Wan's other solvers and policies, and PAB (no new kernel; K6 without the
residual for the first time; the reuse decisions are host masks):
34. requests through ``WanPipeline.generate`` at 832x480x17 and 20 steps,
   phase 5's weights: dpm++ and Euler at full compute, dpm++ with MagCache
   E012K2R02, a dpm++ calibration whose recorded ratios a second request
   installs (``mag_ratios_override``), and the rolling policy at 50 steps
   with 0.12 / K 2 (unipc); skip bits against the schedule, launches against
   the trunk runs, and dpm++'s and Euler's rel L2 against phase 5's unipc;
35. TeaCache requests at 832x480x17, 20 UniPC steps, threshold 0.2, without
   and with ``use_ret_steps``: every forced-window forward computed, launches
   against the realized per-lane bits (a half-batch step is one trunk run),
   the skips per lane printed (bf16 may move a near-threshold decision, so
   they are not held to the CPU's);
36. K6 without the residual against its plain version at 480p (the
   ``fused_cross_attention_bias`` record), then requests at 480p 9:16 x 51
   and 30 RFLOW steps, phase 9's weights: ``OPEN_SORA_PAB``, PAB with
   MagCache opensora-v1.2, and the rolling policy without PAB; the reuse
   steps per site (counted at each site) against ``broadcast_masks`` over
   the trunk runs, launches per trunk run from the step's masks (spatial
   K7 + K5 "prepass", temporal K3 + K5 "stream", K6 without the residual
   twice a pair, K7 mlp1 twice a pair; no K8), peak memory and rel L2
   against phase 9's full compute; then one trunk run's device time per
   reuse signature of the masks, beside full compute and the plain trunk;
37. a ``LATTE_PAB`` request at 512x512 x 16 and 50 DDIM steps, phase 21's
   weights: reuse steps per site, the MLPs' reuse and save block-steps
   (blocks 0-4) against the masks, launches per trunk run (K3 per computed
   attention and MLP, K5r "tma"/"stream", K1 for the cross-attention), peak
   memory and rel L2 against phase 21's full-compute calibration request,
   and one trunk run's device time per reuse signature (the MLP column: any
   block replays);
38. narrow slices on the card (bf16) against the CPU (f32): Wan dpm++
   (phase 6's), STDiT3 under PAB (phase 10's, every window opened) and
   Latte under PAB (phase 22's, an MLP anchor at t = 750), each with
   skipped steps, within 5e-2 rel L2.

Open-Sora-Plan v1.2 and v1.1, CogVideoX-5B (no new kernel; K1 at head dims
72 and 64 on full 3-D and joint sequences, K6 over 512 caption keys, K5r
over groups of 17 on its "tma" body):
39. K1 (running max, 72 padded to 128) at v1.2's 3-D 2x28,800x16x72
   (93x480x640), K7 (qkv, ff1 + gelu), K8 (proj, ff2) and K6 over 512 keys
   at its 2x28,800x1152 shapes, K6 at v1.1's 2x17,408 queries and K5r over
   v1.1's temporal groups of 17 (65x512x512, 34,816 rows, the "tma"
   route), each against its plain version beside SDPA where that computes
   the same function;
40. two full-shape forwards of Open-Sora-Plan v1.2 at 93x480x640 (28,800
   tokens, 2 CFG rows, 28 blocks, packed route): time, peak memory,
   launches per forward;
41. requests through ``OpenSoraPlanPipeline.generate`` (v120) at 29x480x640
   (9,600 tokens) and 30 Euler-Ancestral steps (cut from 150): full compute,
   MagCache (0.12 / K 3 / R 0.2, flat ratios, 2 lanes), a calibration whose
   ratios a second MagCache request installs, and PAB (spatial + cross);
   skip bits against ``compute_skip_schedule``, launches against the trunk
   runs, PAB's reuse per site against ``broadcast_masks``, peak memory;
42. requests through the same pipeline (v110: the Latte-1 trunk, 8 output
   channels) at 65x512x512 (17 latent frames of 1,024 tokens) and 20 PNDM
   steps (cut from 150: 21 model calls): full compute, MagCache, and
   ``OSP_V110_PAB`` with its MLP anchors moved onto the 20-step grid
   (700 and 500, blocks 0-6), launches and K5r routes ("tma" 56 a trunk
   run) checked;
43. CogVideoX-5B (9.5 B parameters, bf16, initialised on the card): K1 at
   the 49x480x720 joint shape 2x17,776x48x64 (padded to 128) against its
   plain version beside SDPA at 64, then two full-shape forwards (17,550
   video + 226 text tokens, 42 blocks);
44. requests through ``CogVideoXPipeline.generate`` at 13x480x720 (frames
   cut from 49: 5,400 video tokens) and 20 DDIM steps (cut from 50): full
   compute, MagCache, dynamic CFG with MagCache, PAB (``COGVIDEOX_PAB``);
45. narrow Open-Sora-Plan v1.2 (both routes), v1.1 (17 latent frames) and
   CogVideoX through their pipelines with skipped steps, bf16 on the card
   against f32 on the CPU, within 5e-2 rel L2.

Vchitect-XL-2B, and the Open-Sora-Plan and CogVideoX VAE decoders (no new
kernel; K1 at head dim 64 over per-frame joint sequences of 1,517 tokens
and from 121,360 queries to 77 keys; the VAEs are cuDNN convs in f32):
46. K1 (running max, 64 padded to 128) at Vchitect's 40x480x768 spatial
   shape 80x1,517x24x64 and cross shape 2x60,680x24x64 x 77 keys (the mock
   context), and at the SD3 stack's 333 context tokens (phase 53's
   request): spatial 80x1,773x24x64 and cross 2x70,920x24x64 x 333 keys,
   each against its plain version beside SDPA at 64;
47. two full-shape forwards of Vchitect-XL-2B (2.42 B parameters, bf16) at
   40x480x768 (40 frames of 30x48 patches + 77 context tokens, 2 CFG rows,
   24 blocks): time, peak memory, 24 spatial + 24 cross K1 launches a
   forward and nothing else of the kernel table (the temporal attention
   over 40 frames takes the einsum path), and a profile;
48. requests through ``VchitectPipeline.generate`` at 16x480x768 (frames
   cut from 40) and 20 FlowMatch-Euler steps (cut from 100), guidance 7.5:
   full compute, MagCache (0.12 / K 3 / R 0.2, flat ratios, 2 lanes), a
   calibration whose ratios a second MagCache request installs, and PAB
   (spatial range 2, temporal range 4 in (100, 800)); skip bits against
   ``skip_mask_for``, launches against the trunk runs, reuse per site
   against ``broadcast_masks``, peak memory;
49. f32 decodes with random weights: the Open-Sora-Plan CausalVAE in the
   v1.2 layout (latents [1, 24, 60, 80, 4] -> pixels [1, 93, 480, 640, 3]:
   two time windows, 3 x 3 tiles) and the v1.1 layout ([1, 17, 64, 64, 4]
   -> [1, 65, 512, 512, 3]), and the CogVideoX VAE's ``decode_tiled``
   ([1, 13, 60, 90, 16] -> [1, 49, 480, 720, 3]): time, peak memory, shape,
   finite;
50. phase 41's and 44's MagCache requests once more with ``vae=`` (phase
   49's v1.2 and CogVideoX VAEs): Open-Sora-Plan from the prompt through
   phase 55's mT5-XXL, pixels [1, 29, 480, 640, 3], and CogVideoX (mock
   text) at 17 frames (the CogVideoX VAE needs an odd latent count: 13
   frames are 4 latent frames, which it decodes to 16), [1, 17, 480, 720,
   3]; ``text_s`` and ``decode_s``;
51. a narrow Vchitect (2 heads of 64, 2 blocks, non-zero ``ot``/``oc``/
   ``add_out_t``, frames of 144 + 20 tokens: K1) through its pipeline with
   skipped steps, bf16 on the card against f32 on the CPU within 5e-2 rel
   L2; both VAEs at their published widths on narrow clips, f32 on the card
   against the CPU within 1e-4 of the largest pixel.

The SD VAE, Open-Sora's temporal VAE and their micro-frame composite, so
FLUX, Kontext, Latte, Vchitect and Open-Sora return pixels (no new kernel;
f32 cuDNN convs, the mid attention plain PyTorch):
52. f32 decodes with random weights at each family's full shape, one call
   each: the FLUX.1 VAE [1, 128, 128, 16] -> [1, 1024, 1024, 3] by
   ``decode`` and ``decode_tiled``, sd-vae-ft (Latte) [1, 16, 64, 64, 4] ->
   [1, 16, 512, 512, 3], the SD3 VAE (Vchitect) [1, 40, 60, 96, 16] ->
   [1, 40, 480, 768, 3] frame by frame in chunks of 8, and Open-Sora's
   ``MicroFrameVAE`` [1, 15, 60, 106, 4] -> [1, 51, 480, 848, 3] (the 480p
   9:16 request's 854 columns are 106 latent columns, 848 pixels): seconds,
   peak memory, parameters, pixel std; shape and finite checked;
53. requests with MagCache from the prompt through phase 56's encoders,
   ending in pixels through phase 52's VAEs: flux-dev and Kontext (T5-XXL x
   512 + CLIP-L pooled; a seeded 1024x1024 image encoded by the FLUX.1 VAE)
   at 1024x1024 x 28 steps, Latte (T5-XXL x 120) 512x512 x 16 x 50 steps
   (flat ratios), Vchitect (the SD3 stack: 333 context tokens) 16x480x768 x
   20 steps (flat ratios), Open-Sora (T5-XXL x 300) 480p 9:16 x 51 x 30
   steps with latent frame 0 pinned to an in-memory image encoded by
   ``MicroFrameVAE.encode`` (no image file, no PIL); pixels, ``text_s``,
   ``decode_s``, skip bits against ``skip_mask_for``, launches against the
   trunk runs;
54. the SD VAE, the temporal VAE and ``MicroFrameVAE`` at tiny widths, f32
   encode and decode on the card against the CPU within 1e-4 of the largest
   value.

The text encoders (no kernel: f32 cuBLAS GEMMs and ATen, TF32 off; random
weights from a seeded generator on the card, the hash tokenizer; one XXL
encoder resident at a time). Phase 55 runs before phase 50, phase 56
before phase 53, phase 57 last:
55. mT5-XXL (5.65 B parameters) encoding a prompt and the negative "" x 512
   tokens: parameters, init seconds, the first and second encode's
   seconds, peak memory, shape; fails on a non-finite output, a wrong shape
   or a nonzero row past the prompt;
56. T5-XXL (4.76 B) at 512, 300, 226 and 120 tokens, as phase 55; CLIP-L
   (0.12 B, legacy EOS) pooled at 77, and CLIP-L and CLIP-bigG (0.69 B) with
   projection and ``hidden_skip`` 1, each failing unless its pooled vector is
   the (projected) normed state at the EOS; the SD3 stack at 77 + 256 tokens
   (context [2, 333, 4096], pooled [2, 2048]);
57. narrow T5 (relu and gated-gelu, block 0's bias), mT5 (its 250,112-token
   vocabulary) and CLIP (quick-gelu pooled and gelu ``hidden_skip`` 1, both
   projected), f32 on the card against the CPU within 1e-4 of the largest
   value.

Wan2.1 I2V-14B and FLF2V-14B (K1, K2, K3, K3p at the 14B widths; the CLIP
ViT-H/14 tower's K1; the Wan VAE's encoder on cuDNN):
58. each kernel against its plain version at the 832x480x81 I2V-14B shapes
   (bf16): K1 self 2x32,760x40x128 with the fixed max, and cross to 512
   text, 257 image (i2v) and 514 image (flf2v) keys, ragged last key tiles,
   q and k of std sqrt(3) so each softmax sits on a few keys (per element
   within 2^-8 max|v| + 2e-2 |plain|: one flipped bf16 rounding of a
   dominant weight; rel L2 within 1e-2);
   K1 at the CLIP tower's 1x257x16x80 (running max, 80 padded to 128) on
   bf16-rounded f32 operands, and that call against the f32 attention
   within 5 x 2^-9 of the largest value; K2 at 40 heads; K3 mod, affine
   and K3p at width 5,120; with SDPA or ``F.layer_norm`` where it computes
   the same function;
59. one full-shape forward of the I2V-14B trunk (16.4 B parameters, bf16,
   drawn on the card) at 832x480x81: 32,760 tokens, 2 lanes, 257 + 512
   context tokens; time, peak memory, launches per forward (K1 120, K2 80,
   K3 120, K3p 1);
60. i2v requests through ``WanPipeline.generate(image=)`` at 832x480x17
   (frames cut from 81) and 20 UniPC steps (cut from 40), shift 3.0: UMT5-XXL text, a
   seeded 720x1280 image through the CLIP ViT-H/14 tower (f32) and the Wan
   VAE encode (f32), the f32 decode; full compute and MagCache
   ``wan2.1-i2v-480p`` (22 of 40 lane-forwards elided); skip bits,
   launches (the trunk's per run, K3p a step, the tower's 31 K1 an image),
   ``text_s``, ``image_s``, ``decode_s``, peak memory; then the tower's
   features of that image against the same tower with the plain f32
   attention on the card, within 31 x 2^-9 rel L2;
61. a flf2v request (first and last image, 514 CLIP tokens) at 832x480x17
   and 20 steps (cut from 50), shift 16, MagCache (22 of 40 elided); then the
   ``CausalVAE`` fallback encoder (base 96, f32) on [image; 16 zero frames]
   at 832x480x17 in one pass;
62. narrow i2v and flf2v pipelines (2 blocks of 2 heads of 128; a 2-block
   CLIP tower of 2 heads of 80 at 257 tokens; a Wan-stride VAE of base 16)
   from seeded images, skipped and lane-asymmetric steps, bf16 DiT on the
   card against f32 on the CPU within 5e-2 rel L2; the tower's features
   within 5 x 2^-9 and the conditioning latents within 1e-4 of the largest
   value.

Wan2.2 TI2V-5B, Wan2.1 VACE and the Wan2.2 A14B MoE (K1, K2, K3, K3p at new
shapes and launch counts):
63. each kernel against its plain version at the 1280x704x121 TI2V-5B
   shapes (27,280 tokens, 24 heads of 128, width 3,072; bf16): K1 self
   (fixed max) and cross to 512 text keys beside SDPA; K2 at 24 heads; K3
   mod, affine and K3p, and K3 mod on the contiguous copy of the per-token
   timestep's t = 0 prefix (2x880 rows), beside ``F.layer_norm`` where it
   computes the same function; the call with the prefix (K3 over every
   row, then K3 on the prefix's copy written over its rows) timed against
   one whole K3;
64. two full-shape forwards of WAN_5B (5.0 B parameters, bf16) at
   1280x704x121 with an image's t = 0 prefix, 2 lanes: time, peak memory,
   launches per forward (K1 60, K2 60, K3 150, K3p 1);
65. a TI2V-5B request through ``WanPipeline.generate(image=)`` at
   1280x704x17, 50 UniPC steps, MagCache ``wan2.2-ti2v-5B-i2v`` (48 of 100
   elided), a seeded image through the Wan2.2 VAE encode (base 160, 48
   channels, patchify 2; f32) and its decode; latent frame 0 against the
   image's encode after sampling;
66. one full-shape forward of VACE-14B (17.3 B parameters; 40 blocks and 8
   VACE blocks) at 832x480x81: time, peak memory, launches (K1 96, K2 96,
   K3 144, K3p 1);
67. VACE-1.3B requests at 832x480x17, 50 steps, shift 16, MagCache
   ``wan2.1-vace-1.3B`` (50 of 100 elided), from a seeded source video and
   box mask through the Wan VAE encode and decode (f32), and an R2V request
   with one reference image (6 latent frames sampled, 5 kept);
68. the A14B MoE at 832x480x17, 24 steps (cut from 40), both WAN_14B
   experts resident: t2v-A14B (shift 12, CFG (3.0, 4.0), 17 of 48 elided,
   boundary step 16) and i2v-A14B from a seeded image (shift 5, CFG (3.5,
   3.5), 13 of 48, boundary 9; lane-asymmetric steps on both); each
   expert's trunk runs counted against the computed steps before and after
   the switch;
69. narrow VACE, ti2v (an image through a Wan2.2-layout VAE) and t2v-A14B
   (two experts, MagCache across the switch) pipelines, bf16 DiT on the
   card against f32 on the CPU within 5e-2 rel L2, and the ti2v image
   latents within 1e-4 of the largest value.

HunyuanVideo T2V and FramePack (K1, K2 in head scope, K3; one 12.8 B
MMDiT with FramePack's clean-latent projections for every phase):
70. K2h over the 3-D tables (720x1280x129: 118,800 video + 256 text
   tokens) and a FramePack section's tables, K1 over the joint sequences
   of 1x119,056 and of a FramePack section (1x17,920) with the fixed max
   (the plain version timed by its one comparison call, SDPA beside), the
   token refiner's K1 over 256 tokens with the running max, and K3 mod at
   1x118,800x3,072, each against its plain version;
71. one full-shape forward at 720x1280x129, its launches (K1 60 fixed + 2
   running, K2h 160, K3 121) and peak memory;
72. a HunyuanVideo request from the prompt at 720x1280x17 x 20 Euler
   steps (cut from 50), MagCache hunyuanvideo-720p (13 of 20 elided): Llava-Llama-3-8B
   (f32, no output head, the template's prefix cropped at its hash
   tokenizer words) and CLIP-L pooled on the card beside the DiT;
73. FramePack requests at 768x512, 2 sections of 9 latent frames x 10
   steps (cut from 25), a start latent from a seeded image: the padded mode
   with MagCache framepack and F1 with framepack-f1 (5 of 10 elided in
   every section, ``on_section`` once a section);
74. one TeaCache section (FRAMEPACK_TEA_COEFFS, the first and last step
   forced), its launches from its realized bits;
75. narrow HunyuanVideo and FramePack pipelines, bf16 MMDiT on the card
   against f32 on the CPU within 5e-2 rel L2, and a narrow Llama in f32
   within 1e-4 of the largest value.

Qwen-Image and Qwen-Image-Edit (K1, K2 in head scope, K3; one 20.4 B MMDiT
of 60 double blocks for phases 77-79):
76. K2h over the image and text rope tables of 1664x928 (2x6,032 image q
   rows, 2x256 text k rows, Edit's 2x12,064 with the reference on index 1),
   K1 over the joint sequences of two CFG lanes, 2x6,288x24x128 and Edit's
   2x12,320 (fixed max; SDPA beside), and K3 mod on both streams
   (``F.layer_norm`` beside: the lanes share one modulation), each against
   its plain version;
77. text-to-image and Edit forwards at 1664x928, twice each: seconds,
   peak memory, launches per forward (K1 60, K2h 240, K3 241);
78. requests from the prompt at 1664x928 x 20 Euler steps (cut from 50),
   true CFG 4.0: the Qwen2.5-VL-7B text tower (7.07 B, f32, template prefix
   of 34 tokens cropped, a special-token tokenizer) beside the DiT; full
   compute and MagCache qwen-image (8 of 40 lane-forwards elided), their
   time ratio against the schedule's ceiling;
79. an Edit request from a seeded 928x1664 image: the Wan VAE's one-frame
   encode (f32) into the reference latents (its first part, run before
   phase 78 builds the LM: the VAE's mid attention needs the room), the
   Qwen2.5-VL vision tower (f32) spliced into phase 78's LM with M-RoPE
   (the pads counted against the merged tokens), MagCache qwen-image-edit
   x 20 steps;
80. narrow text-to-image and Edit pipelines (2 blocks of 2 heads of 128)
   with skipped and lane-asymmetric steps, bf16 on the card against f32 on
   the CPU within 5e-2 rel L2; a narrow vision tower and the M-RoPE stack
   through it, f32, within 1e-4 of the largest value.

OmniGen2 (K1 only, at head dim 120 zero-padded to 128; the q/k norm and RoPE
stay plain at that head dim, as in JAX; one 3.012 B DiT for phases 82-84):
81. K1 against its plain version at 1024x1024 shapes on q/k from the plain
   RMS norm + RoPE (21 query heads over 7 repeated kv heads, fixed max):
   edit's with-refs joint 2x8,320, text-to-image 2x4,224, the ref-free
   1x4,224 and the noise / reference refiners' 2x4,096, each beside SDPA
   at head dim 120 and checked bit-equal to ``attention()``'s own padded
   call; the context refiner's 2x128 (``attention()``'s einsum path, no
   launch); the plain q/k prologue's time at 2x8,320x(21 + 7)x120;
82. forwards of the text-to-image program and of edit's two programs
   (with-refs, ref-free), twice each: seconds, peak memory, K1 launches per
   forward (32 trunk + 2 per image refiner); one profiled with-refs forward;
83. requests at 1024x1024 x 20 Euler steps (cut from 50): text-to-image
   full compute and MagCache (24 of 40 lane-forwards elided), edit with one
   seeded reference latent full compute and MagCache (33 of 60: cond /
   uncond / ref 11 / 11 / 11, steps where cond and ref disagree run the half-batch
   trunk); skip bits per lane against ``compute_skip_schedule`` of
   ``make_omnigen2_cache_config``, K1 launches against the trunk runs of
   each program and the prepares, the speedups against the ceilings;
84. edit at 1024x1024 x 20 steps: TaylorSeer (the 7 fresh steps of
   ``taylorseer_schedule`` run the trunks) and DPM-Solver++(2M) with
   MagCache; at 10 steps TeaCache (first and last steps forced) and
   calibration ((steps - 1) x 3 finite ratios);
85. narrow text-to-image and edit (2 references) pipelines at head dim 120
   (hidden 480, 4 heads over 2), MagCache with skips, bf16 on the card
   against f32 on the CPU within 5e-2 rel L2, K1 launches as counted.

Serving and evaluation, Wan2.1 T2V-1.3B at 832x480x17 x 20 steps (K1, K2,
K3, K3p; phase 5's seeded weights):
86. ``serve.PipelineServer(max_batch=2)`` behind ``make_http_server`` on
   127.0.0.1, over loopback HTTP: a warmup pair (the largest batch),
   sync requests at E012K2R02,
   full compute (``use_magcache: false``) and E024K6R02 with their
   latents, an async request polled at ``/jobs/<id>``, two concurrent
   requests micro-batched into one ``generate_batch`` (2 prompts x 2 CFG
   lanes = 4 rows), ``/healthz`` (naming the card) and ``/info``; checks
   status codes, skip counts against ``skip_mask_for``, launches against
   the trunk runs (a batch one a step), the served latents bit-equal to
   ``generate`` at the same seed, each batched element (the async request
   alone, the concurrent pair) bit-equal to its single run, peak memory
   flat (5%), and K1, K2 and K3 at the
   batch-of-4 shape against their plain versions; then
   ``python -m magcache_tpu_torch.cli.serve`` as a subprocess: its address,
   one request against the in-process latents, SIGINT, exit 0;
87. ``eval.sweep.run_sweep`` over two ``DEFAULT_PROMPTS``: full compute one
   prompt at a time, MagCache with ``dp=2`` (one ``generate_batch``), their
   manifests, launches against the realized schedules, both
   ``sec_per_video_mean``; ``eval.compare.compare_dirs`` of the MagCache
   latents against the full ones (finite PSNR and SSIM);
88. published checkpoints: the seeded Wan2.1 T2V-1.3B (phase 5's weights),
   UMT5-XXL at full width (``CKPT_UMT5_LAYERS`` of 24 layers) and the f32 Wan
   VAE written under the published names (``wan_published``,
   ``umt5_published``, ``wan_vae_published``: maps kept here, apart from the
   package's converters) to a temporary ``ckpt_dir``: the DiT as two BF16
   safetensors shards, the encoder as ``models_t5_umt5-xxl-enc-bf16.pth``,
   the VAE as ``Wan2.1_VAE.pth``; bytes, seconds and peak RSS printed. The
   CLI's pipeline builder loads it (``--ckpt_dir``, ``--vae_ckpt``): the
   DiT, encoder and VAE bit-equal to the seeded weights as written; a
   request at 832x480x17 x 20 steps, E012K2R02, bit-equal in latents,
   skips and pixels to the same request on the seeded in-process pipeline,
   launches as counted (K1, K2, K3, K3p), pixels finite. The directory is
   removed; a lack of disk space fails the phase;
89. OmniGen2 (3.012 B, phase 82's seed) written with a ``config.json``: the
   configuration sniffed from it equals the in-process one; a PEFT adapter
   (rank 16, alpha, on every trunk and noise-refiner attention projection)
   merged by ``OmniGen2Pipeline(ckpt_dir=, lora_path=)`` on the card equals
   ``W + scale (alpha / r) B A`` computed here in f32 and rounded to bf16,
   tensor for tensor; a text-to-image forward at 1024x1024 (K1 34 times)
   equals that of the same merged weights built in-process.

Every request of phases 63-69 checks its skip bits against
``compute_skip_schedule``, its launches against the trunk runs and its
pixels and latents for shape and finiteness, and prints ``text_s``,
``image_s`` (where it encodes), ``decode_s``, ``total_s`` and its peak
memory.

Kernel times are CUDA-event times of a loop of back-to-back launches
between one event pair, divided by the count (``cuda_ms``); each attention
kernel's line adds its TFLOP/s and its share of the bound; phase 11 times
the short K2h and K3 calls as one replay of a CUDA graph of 20 calls
(``cuda_graph_ms``), since their wrappers' host dispatch outlasts them. The
second-to-last line of stdout is the kernels' JSON record: one entry per
kernel (K2's token and head scopes apart, K1 and K1q apart, K5 and K5r
apart, and K3 and K3p apart, each counted by its own launch count) with its
launches on each path (``wan-ulysses`` and ``wan-ring``: phase 25's requests
; ``latte-vpu``: phase 20's two vpu forwards; ``open-sora-grouped``: phase
28's two grouped forwards and phase 29's request; ``open-sora-vpu``: phase
28's two vpu forwards; ``open-sora-noqknorm``: phase 30's four forwards;
``wan-video``: phase 33's request; ``wan-solvers``, ``wan-teacache``:
phases 34 and 35; ``open-sora-pab`` and ``open-sora-rolling``: phase 36's
PAB requests and its rolling one; ``latte-pab``: phase 37;
``open-sora-plan``: phases 40 and 41; ``open-sora-plan-v110``: phase 42;
``cogvideox``: phases 43 and 44; ``vchitect``: phases 47 and 48;
``open-sora-plan-pixels`` and ``cogvideox-pixels``: phase 50;
``flux-pixels``, ``latte-pixels``, ``vchitect-pixels``, ``open-sora-pixels``:
phase 53; ``wan-i2v``: phases 59 and 60; ``wan-flf2v``: phase 61;
``wan-ti2v``: phases 64 and 65; ``wan-vace``: phases 66 and 67;
``wan-a14b``: phase 68; ``hunyuan``: phases 71 and 72; ``framepack``:
phases 73 (padded) and 74; ``framepack-f1``: phase 73; ``qwen-image``:
phases 77 (two text-to-image forwards) and 78; ``qwen-image-edit``: phases
77 (two Edit forwards) and 79; ``omnigen2``: phases 82 (two text-to-image
forwards) and 83; ``omnigen2-edit``: phases 82 (two forwards of each edit
program), 83 and 84; ``wan-serve``: phase 86's in-process served requests;
``wan-sweep``: phase 87's two sweeps; ``wan-ckpt``: phase 88's loaded
request; ``omnigen2-lora``: phase 89's loaded forward), its worst error over every shape
compared, and the times of its first shape timed, named in ``timed_at``,
with their method in ``timing`` (``loop`` or ``graph``); ``shapes`` lists
every shape compared with its own error, times and bound.
``bound_ms`` is the least time an H100 SXM could take at that shape: the
larger of the bytes moved (each input read once, each output written once)
over 3.35 TB/s and the operations over the peak rate of their type (989
TFLOP/s for the tensor-core products, 67 TFLOP/s for f32 elementwise work),
with ``bound_by`` naming which. ``library_ms`` is one PyTorch call computing
the same function at that shape (``library_call`` names it), else null.
The last line is ``{"ok": true, "device": {...}}``. Weights are random
(seeded); the checkpoints phases 88 and 89 read are those they write.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import subprocess
import time

import numpy as np
import torch

STEPS = 20            # enough that E012K2R02 elides forwards at 20 steps
WAN_PROMPT = "Two anthropomorphic cats fight on a stage."
# Launches per trunk run of every kernel record (K2's token scope
# ``rms_norm_rope`` and head scope ``rms_norm_rope_head`` apart). Wan: 30
# blocks
NO_LAUNCHES = dict.fromkeys(
    ("flash_attention_bshd", "flash_attention_bshd_qknorm", "rms_norm_rope",
     "rms_norm_rope_head", "layer_norm_mod", "layer_norm_mod_plain",
     "flash_attention_bhsd", "flash_attention_bhsd_aux", "grouped_attention_fused_qkv",
     "grouped_attention_fused_qkv_rowmax", "grouped_flash_attention_bshd",
     "tiny_temporal_attention", "fused_cross_attention", "fused_cross_attention_bias",
     "lnmod_matmul", "matmul_gated_residual"), 0)
TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=60, rms_norm_rope=60,
                      layer_norm_mod=90)
SP = 4                # local ranks of the sequence-parallel phases


def sp_trunk_launches(layers: int, sp: int, impl: str) -> dict:
    """Launches of one sequence-parallel Wan trunk run, summed over the
    ``sp`` ranks: per block and rank, Ulysses runs K1b twice (self, cross);
    the ring runs K1c ``sp`` times (one per key shard) and K1b once (cross)."""
    per_rank = dict(NO_LAUNCHES, rms_norm_rope=2 * layers, layer_norm_mod=3 * layers)
    if impl == "ring":
        per_rank.update(flash_attention_bhsd_aux=sp * layers, flash_attention_bhsd=layers)
    else:
        per_rank.update(flash_attention_bhsd=2 * layers)
    return {k: n * sp for k, n in per_rank.items()}


def wan_launches(trunk: dict, runs: int, head_calls: int) -> dict:
    """Launches of a Wan run: ``trunk`` per trunk run, plus the head's K3p
    once per head call (every step, skipped or not, on every rank)."""
    return {k: n * runs + (head_calls if k == "layer_norm_mod_plain" else 0)
            for k, n in trunk.items()}
# Open-Sora: 28 (spatial, temporal) block pairs per trunk run
OS_TRUNK_LAUNCHES = dict(NO_LAUNCHES, grouped_attention_fused_qkv=56,
                         fused_cross_attention=56, lnmod_matmul=84,
                         matmul_gated_residual=112, layer_norm_mod=28)
OS_STEPS, OS_FRAMES = 30, 51
# FLUX.1: 19 double + 38 single blocks per trunk run; the head adds one K3
# launch per step, skipped or not
FLUX_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=57,
                           rms_norm_rope_head=152, layer_norm_mod=114)
FLUX_STEPS, FLUX_TXT, FLUX_GRID = 28, 512, (64, 64)
# Open-Sora at 720p 9:16: frames of 45 x 80 = 3,600 tokens take K1q in the
# spatial blocks, K5 stays in the temporal ones; the masked-frame blocks run
# the unfused composition (no K3, K7 or K8)
OS720_TRUNK_LAUNCHES = dict(OS_TRUNK_LAUNCHES, grouped_attention_fused_qkv=28,
                            flash_attention_bshd_qknorm=28)
OS720_MASKED_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd_qknorm=28,
                             grouped_attention_fused_qkv=28, fused_cross_attention=56)
OS720_FRAMES, OS720_GRID = 17, (5, 45, 80)
# K5/K5r/K4 launches per trunk run by route (ops.attention.grouped_kernel):
# "prepass" (groups above 16 tokens with gains or RoPE: STDiT3's spatial
# frames), "tma" (the row max without them: Latte's frames), "stream"
# (groups of up to 16 tokens: every temporal call)
NO_ROUTES = {"stream": 0, "tma": 0, "prepass": 0}
OS_ROUTES = dict(NO_ROUTES, stream=28, prepass=28)
OS720_ROUTES = dict(NO_ROUTES, stream=28)
LATTE_ROUTES = {"packed": dict(NO_ROUTES, stream=28, tma=28),
                "grouped": dict(NO_ROUTES, stream=28), "vpu": NO_ROUTES}
# K9's launches per trunk run by route (ops.tiny_attention.tiny_kernel_route):
# the vpu route's temporal attention, 16 frames of head dim 72, streams
NO_TINY_ROUTES = {"stream": 0, "general": 0}
LATTE_TINY_ROUTES = {"packed": NO_TINY_ROUTES, "grouped": NO_TINY_ROUTES,
                     "vpu": dict(NO_TINY_ROUTES, stream=28)}
# Latte-1 at 512x512 x 16 frames: 28 (spatial, temporal) block pairs per
# trunk run, by route
LATTE_TRUNK_LAUNCHES = {
    "packed": dict(NO_LAUNCHES, layer_norm_mod=28, grouped_attention_fused_qkv_rowmax=56,
                   fused_cross_attention=28, lnmod_matmul=84, matmul_gated_residual=112),
    "grouped": dict(NO_LAUNCHES, layer_norm_mod=112, flash_attention_bshd=56,
                    grouped_flash_attention_bshd=28),
    "vpu": dict(NO_LAUNCHES, layer_norm_mod=112, flash_attention_bshd=56,
                tiny_temporal_attention=28)}
LATTE_STEPS, LATTE_GRID, LATTE_CAP = 50, (16, 32, 32), 120
H100_BF16_TFLOPS = 989.0  # dense bf16 peak of an H100 SXM at 700 W
H100_F32_TFLOPS = 67.0    # f32 outside the tensor cores
H100_HBM_TBPS = 3.35      # HBM3 bytes/s
ELEMENTWISE_OPS = 8       # f32 operations per element of K2/K3 (norm, affine, rope)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` back-to-back calls
    between one pair of CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_graph_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn`` in ms without the host's dispatch:
    ``reps`` calls captured in one CUDA graph, timed over one replay. For
    kernels shorter than their wrapper's host overhead, where ``cuda_ms``
    measures the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm up off the capture, as required
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """``(fn(), ms)``: one call between a pair of CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def bound(flops: float, nbytes: float, tflops: float = H100_BF16_TFLOPS):
    """``(ms, "operations" | "bytes")``: the least time an H100 SXM could
    take for ``flops`` operations at ``tflops`` and ``nbytes`` of device
    memory traffic, and which of the two binds."""
    ops_ms = flops / (tflops * 1e9)
    bytes_ms = nbytes / (H100_HBM_TBPS * 1e9)
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rate(flops: float, moved: float, ms: float, tflops: float = H100_BF16_TFLOPS) -> str:
    """Achieved TFLOP/s at ``ms`` and the share of the bound (``bound``) it
    reaches."""
    bound_ms, by = bound(flops, moved, tflops)
    return f"{flops / ms / 1e9:.1f} TFLOP/s, {bound_ms / ms:.1%} of the {by} bound"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def elementwise_work(x: torch.Tensor, *small):
    """Work of K2/K3 over ``x``: ELEMENTWISE_OPS f32 operations per element,
    x read and an output of its size written, plus the ``small`` tensors
    (gains, tables, modulations) read once."""
    return (ELEMENTWISE_OPS * x.numel(), 2 * nbytes(x) + nbytes(*small), H100_F32_TFLOPS)


def sdpa_ms(q, k, v, reps: int) -> float:
    """``F.scaled_dot_product_attention`` on ``[B, S, H, D]`` q/k/v (as
    ``[B, H, S, D]`` views), the library yardstick of K1 and K1q."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), reps)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
            rtol: float, rel_tol: float = 1e-2) -> float:
    """Fails unless |got - want| <= atol + rtol*|want| everywhere and the
    relative L2 error is within ``rel_tol``."""
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    worst = float((err - rtol * w.abs()).max())
    max_abs = float(err.max())
    rel = float((g - w).norm() / w.norm())
    log(f"  {name}: max_abs_err={max_abs:.3e} rel_l2_err={rel:.3e} (tol "
        f"{atol} + {rtol}*|plain| per element, worst excess {worst - atol:.3e}; "
        f"rel L2 tol {rel_tol})")
    if worst > atol or rel > rel_tol:
        fail(f"{name}: kernel disagrees with its plain version")
    return max_abs


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    g, w = got.float().cpu(), want.float().cpu()
    return float((g - w).norm() / w.norm())


def phase_environment():
    log("phase 1: environment")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")


def phase_build(dev):
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.build import load_cuda_library

    log("phase 2: build")
    t0 = time.time()
    load_cuda_library()
    t_nvcc = time.time() - t0
    # first launches compile the Triton kernels at the main path's widths
    x = torch.randn(1, 256, 1536, device=dev, dtype=torch.bfloat16)
    g = torch.ones(1536, device=dev)
    tab = torch.zeros(256, 64, device=dev)
    P.rms_norm_rope(x, g, tab, tab, 12, eps=1e-6)
    P.rms_norm_rope(x[..., :768], g[:128], tab, tab, 6, eps=1e-6, norm_scope="head")
    P.layer_norm_mod(x, scale=g[None, None], shift=g[None, None], eps=1e-6)
    P.layer_norm_mod(x, weight=g, bias=g, eps=1e-6)
    q = torch.randn(1, 256, 12, 128, device=dev, dtype=torch.bfloat16)
    A.flash_attention_bshd(q, q, q, fixed_max=16.0)
    A.flash_attention_bshd(q, q, q)
    # the sequence-parallel path's kernels, from one thread before any rank runs
    P.layer_norm_mod(x, eps=1e-6)
    qh = q.transpose(1, 2)
    A.flash_attention_bhsd(qh, qh, qh, fixed_max=16.0)
    A.flash_attention_bhsd(qh, qh, qh)
    A.flash_attention_bhsd_aux(qh, qh, qh)
    torch.cuda.synchronize()
    log(f"  build: nvcc {t_nvcc:.1f} s, Triton compile + first launches "
        f"{time.time() - t0 - t_nvcc:.1f} s")


def phase_kernels(dev, rec):
    """Each kernel vs its plain version at the main path's shapes."""
    from magcache_tpu_torch.models.wan import WAN_1_3B, wan_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    log("phase 3: kernels vs plain at Wan2.1-1.3B 832x480x81 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(1234)
    B, S, H, D, L = 2, 21 * 30 * 52, 12, 128, 512
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K1: bf16 out; kernel and plain round at the same points, only the f32
    # summation order differs -> a bf16 ulp or two of the output
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    ck, cv = rnd(B, L, H, D), rnd(B, L, H, D)
    Sr = 5 * 30 * 52        # phase 5's requests: 7,800 tokens, ragged 128-row tiles
    cases = [("self, fixed_max=16", (q, k, v), 16.0),
             ("cross 512 keys, fixed_max=16", (q, ck, cv), 16.0),
             ("self, running max", (q, k, v), None),
             (f"request self {Sr} tokens, fixed_max=16",
              (q[:, :Sr], k[:, :Sr].contiguous(), v[:, :Sr].contiguous()), 16.0)]
    for label, (qq, kk, vv), fm in cases:
        qq = qq.contiguous()
        got = A.flash_attention_bshd(qq, kk, vv, fixed_max=fm)
        want = A.flash_attention_bshd_plain(qq, kk, vv, fixed_max=fm)
        err = compare(f"K1 flash_attention_bshd [{label}]", got, want,
                      atol=2e-3, rtol=2e-2)
        ms = cuda_ms(lambda: A.flash_attention_bshd(qq, kk, vv, fixed_max=fm), 5)
        pms = cuda_ms(lambda: A.flash_attention_bshd_plain(qq, kk, vv,
                                                           fixed_max=fm), 2)
        lms = sdpa_ms(qq, kk, vv, 5)
        flops = 4 * B * H * qq.shape[1] * kk.shape[1] * D
        moved = 2 * nbytes(qq) + nbytes(kk, vv)
        log(f"  K1 [{label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), "
            f"plain {pms:.3f} ms, SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop",
             f"2x{qq.shape[1]}x12x128 {label}", (flops, moved),
             ("F.scaled_dot_product_attention", lms))
    del q, k, v, ck, cv

    # K2/K3: a flipped bf16 rounding of the normed value moves an output by
    # one ulp of its largest pair element -> atol 3e-2 at |y| < 8
    x = rnd(B, S, H * D, scale=2.0)
    gain = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    cos_np, sin_np = wan_rope_tables(WAN_1_3B, (21, 30, 52))
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    got = P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6)
    err = compare("K2 rms_norm_rope [token scope]", got, want, atol=3e-2,
                  rtol=1.6e-2)
    ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6))
    pms = cuda_ms(lambda: P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6))
    gbs = 2 * x.numel() * 2 / ms / 1e6
    log(f"  K2: kernel {ms:.3f} ms ({gbs:.0f} GB/s), plain {pms:.3f} ms")
    keep(rec, "rms_norm_rope", err, ms, pms, "loop", "2x32760x1536",
         elementwise_work(x, gain, cos, sin))

    sc = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    sh = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    w = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    bias = rnd(H * D, dtype=torch.float32, scale=0.1)
    for label, kw in (("mod", dict(scale=sc, shift=sh)),
                      ("affine", dict(weight=w, bias=bias))):
        got = P.layer_norm_mod(x, eps=1e-6, **kw)
        want = P.layer_norm_mod_plain(x, eps=1e-6, **kw)
        err = compare(f"K3 layer_norm_mod [{label}]", got, want, atol=3e-2,
                      rtol=1.6e-2)
        ms = cuda_ms(lambda: P.layer_norm_mod(x, eps=1e-6, **kw))
        pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, eps=1e-6, **kw))
        lib = None
        if label == "affine":      # one library call computes the affine form
            wb, bb = w.to(x.dtype), bias.to(x.dtype)
            lib = ("F.layer_norm", cuda_ms(lambda: torch.nn.functional.layer_norm(
                x, (H * D,), wb, bb, eps=1e-6)))
        log(f"  K3 [{label}]: kernel {ms:.3f} ms "
            f"({2 * x.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms"
            + (f", F.layer_norm {lib[1]:.3f} ms" if lib else ""))
        keep(rec, "layer_norm_mod", err, ms, pms, "loop", f"2x32760x1536 {label}",
             elementwise_work(x, *kw.values()), lib)


def make_model(dev):
    from magcache_tpu_torch.models.wan import WAN_1_3B, WanModel

    cfg = dataclasses.replace(WAN_1_3B, dtype="bfloat16")
    t0 = time.time()
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  WAN_1_3B bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def phase_forward(dev, model):
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import make_wan_core

    log("phase 4: one full-shape forward, WAN_1_3B 832x480x81, 2 lanes")
    grid = (21, 30, 52)
    core = make_wan_core(model, grid)
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((2, 21, 60, 104, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    ctx = MockTextEncoder(512, 4096, scale=0.5)(["a cat", ""], device=dev)
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, c = core.prepare(x, t, {"context": ctx})
        out = core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        log(f"  forward ({run} call): {time.time() - t0:.3f} s, "
            f"{hidden.shape[1]} tokens")
    if tuple(out.shape) != (2, 21, 60, 104, 16) or not bool(torch.isfinite(out).all()):
        fail(f"forward output {tuple(out.shape)} is not finite or misshapen")
    log(f"  output {tuple(out.shape)} finite, std {float(out.float().std()):.4f}")
    return x, t, ctx, out


def _wrappers():
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops import tiny_attention as TA

    return (A.flash_attention_bshd, A.flash_attention_bhsd, A.flash_attention_bhsd_aux,
            P.rms_norm_rope, P.layer_norm_mod, A.grouped_attention_fused_qkv, A.grouped_flash_attention_bshd,
            TA.tiny_temporal_attention, A.fused_cross_attention,
            P.lnmod_matmul, P.matmul_gated_residual)


def reset_counts():
    """Sets every kernel wrapper's launch counts to 0."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops import tiny_attention as TA

    for fn in _wrappers():
        fn.launches = 0
    TA.tiny_temporal_attention.routes.update(NO_TINY_ROUTES)
    A.flash_attention_bshd.qknorm_launches = 0
    A.flash_attention_bshd.modes.update(fixed=0, running=0)
    P.layer_norm_mod.plain_launches = 0
    A.grouped_attention_fused_qkv.rowmax_launches = 0
    A._grouped_launch.routes.update(NO_ROUTES)
    P.rms_norm_rope.scope_launches.update(token=0, head=0)
    A.fused_cross_attention.epilogues.update(resid=0, bias=0)


def read_counts() -> dict:
    """Every kernel record's launch count: K2's two scopes, K1 and K1q, K3
    and K3p, K5 and K5r, and K6 with and without the residual each from its
    own count."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    counts = {fn.__name__: fn.launches for fn in _wrappers()}
    scopes = P.rms_norm_rope.scope_launches
    counts.update(rms_norm_rope=scopes["token"], rms_norm_rope_head=scopes["head"],
                  flash_attention_bshd_qknorm=A.flash_attention_bshd.qknorm_launches,
                  layer_norm_mod_plain=P.layer_norm_mod.plain_launches,
                  grouped_attention_fused_qkv_rowmax=(
                      A.grouped_attention_fused_qkv.rowmax_launches),
                  fused_cross_attention=A.fused_cross_attention.epilogues["resid"],
                  fused_cross_attention_bias=A.fused_cross_attention.epilogues["bias"])
    return counts


def check_routes(label: str, runs: int, want: dict, tiny: dict = NO_TINY_ROUTES) -> None:
    """Fails unless the grouped kernels' launches by route since the last
    ``reset_counts`` are ``want`` per trunk run over ``runs`` runs (no
    "tiled" route: the mma.sync kernel for large groups is gone), and K9's
    are ``tiny``."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import tiny_attention as TA

    for kind, got, per_run in (("grouped", dict(A._grouped_launch.routes), want),
                               ("K9", dict(TA.tiny_temporal_attention.routes), tiny)):
        log(f"  {label}: {kind} launches by route {got} ({runs} trunk runs)")
        if got != {k: n * runs for k, n in per_run.items()}:
            fail(f"{label}: {kind} routes {got} != {per_run} x {runs}")


def count_launches(counts_before: dict) -> dict:
    """Launches of each kernel record since ``counts_before``."""
    return {k: n - counts_before[k] for k, n in read_counts().items()}


def keep(rec: dict, name: str, err: float, ms: float, pms: float, timing: str,
         shape: str, work: tuple, library: tuple = None) -> None:
    """Keeps a kernel's result for the JSON line: the worst error over every
    shape compared, and for the first shape timed its times with how they
    were timed (``loop``: ``cuda_ms``, ``graph``: ``cuda_graph_ms``), its
    bound from ``work`` (``bound``'s arguments at that shape) and the time
    of ``library`` (``(call, ms)``), a PyTorch call computing the same
    function there. Logs the bound at every shape."""
    bound_ms, bound_by = bound(*work)
    log(f"    {name} [{shape}]: bound {bound_ms:.4f} ms by {bound_by}")
    at = {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": pms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "library_ms": library[1] if library else None, "timing": timing}
    if name in rec:
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"], err)
        rec[name]["shapes"].append(at)
        return
    rec[name] = {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "library_ms": library[1] if library else None,
                 "library_call": library[0] if library else None,
                 "timing": timing, "timed_at": shape, "shapes": [at]}


def phase_requests(dev, model):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 5: requests through WanPipeline.generate, 832x480x17, "
        f"{STEPS} UniPC steps, CFG 5.0")
    base = dict(size=(832, 480), frame_num=17, sample_steps=STEPS,
                sample_shift=5.0, guide_scale=5.0)
    full = WanPipeline(WanPipelineConfig(**base), dev, model=model)
    cached = WanPipeline(WanPipelineConfig(use_magcache=True, **base), dev,
                         model=model)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(STEPS, 2)
    if not sched.any():
        fail("E012K2R02 elides no forward at this step count")
    # the same schedule with the uncond lane computing on every other skipped
    # step: lane-asymmetric steps run the half-batch trunk
    asym = sched.copy()
    asym[np.flatnonzero(sched.all(1))[::2], 1] = False
    requests = [("full compute", full, None, np.zeros((STEPS, 1), bool)),
                ("MagCache E012K2R02", cached, None, sched),
                ("MagCache, lane-asymmetric override", cached, asym, asym)]
    reset_counts()
    total = dict(NO_LAUNCHES)
    latents = {}
    for label, pipe, override, want in requests:
        before = read_counts()
        out = pipe.generate(WAN_PROMPT, seed=3, skip_override=override)
        launched = count_launches(before)
        lat = out.latents
        if tuple(lat.shape) != (1, 5, 60, 104, 16) or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, want):
            fail(f"{label}: realized skips differ from the schedule")
        runs = int((~out.skips.all(1)).sum())
        expected = wan_launches(TRUNK_LAUNCHES, runs, STEPS)
        for k, got in launched.items():
            if got != expected[k]:
                fail(f"{label}: {k} launched {got} times, expected {expected[k]} "
                     f"({TRUNK_LAUNCHES[k]} x {runs} trunk runs; K3p once per step)")
            total[k] += got
        latents[label] = lat.float().cpu()
        log(f"  {label}: {out.timings['total_s']:.3f} s, skipped "
            f"{int(out.skips.sum())} lane-forwards of {STEPS * 2}, "
            f"{runs} trunk runs ({int((out.skips.sum(1) == 1).sum())} "
            f"half-batch), latents std {float(lat.std()):.4f}")
    log(f"  launches in phase 5: {total}")
    return total, latents, sched


def _numpy_wan_tree(cfg, rng):
    """A random Wan parameter tree in the JAX package's layout (depth-stacked
    blocks, ``w: [d_in, d_out]``)."""
    d, L = cfg.dim, cfg.layers

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    blocks = {n: lin(d, d, L) for n in ("q", "k", "v", "o", "cross_q",
                                        "cross_k", "cross_v", "cross_o")}
    blocks.update(ffn1=lin(d, cfg.ffn_dim, L), ffn2=lin(cfg.ffn_dim, d, L),
                  modulation=rng.standard_normal((L, 6, d)) / math.sqrt(d))
    for n in ("norm_q", "norm_k", "cross_norm_q", "cross_norm_k", "norm3_w"):
        blocks[n] = 1.0 + 0.1 * rng.standard_normal((L, d))
    blocks["norm3_b"] = 0.1 * rng.standard_normal((L, d))
    return {"patch_embedding": lin(cfg.patch_in, d),
            "text_embedding": {"in": lin(cfg.text_dim, d), "out": lin(d, d)},
            "time_embedding": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "time_projection": lin(d, 6 * d),
            "blocks": blocks,
            "head": {"modulation": rng.standard_normal((2, d)) / math.sqrt(d),
                     "out": lin(d, cfg.patch_out)}}


NARROW_LAYERS = 2
# steps 2 (both lanes skip), 4 and 5 (one lane skips)
NARROW_MASK = np.array([[0, 0], [0, 0], [1, 1], [0, 0], [1, 0], [0, 1]], bool)


def _narrow_wan_inputs(cfg):
    """(parameter tree, initial latents) of the narrow slice, from one seed."""
    rng = np.random.default_rng(11)
    tree = _numpy_wan_tree(cfg, rng)
    return tree, rng.standard_normal((1, 2, 16, 24, cfg.in_channels)).astype(np.float32)


def narrow_wan_model(device, dtype):
    """The narrow Wan model (2 blocks, 2 heads of 128) with numpy weights
    from a seed, converted as a checkpoint would be."""
    from magcache_tpu_torch.models.convert import wan_params_from_numpy
    from magcache_tpu_torch.models.wan import WanConfig, WanModel

    cfg = WanConfig.tiny(dim=256, heads=2, ffn_dim=512, layers=NARROW_LAYERS,
                         dtype=str(dtype).split(".")[1])
    model = WanModel(cfg, device)
    model.load_state_dict(wan_params_from_numpy(_narrow_wan_inputs(cfg)[0], cfg, device))
    return model


def narrow_wan_run(model, plan=None, sp_impl="auto"):
    """The narrow Wan slice (192 tokens, 6 UniPC steps with skipped ones) on
    the model's device; under a ``plan`` it is one rank's run. Returns the
    f32 latents on the CPU."""
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_unipc
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import make_wan_core
    from magcache_tpu_torch.schedulers.unipc import UniPCSchedule

    cfg = model.cfg
    device = model.patch_embedding.weight.device
    grid = (2, 8, 12)                     # 192 tokens: K1 runs (> 128)
    x0 = _narrow_wan_inputs(cfg)[1]
    ctx = MockTextEncoder(cfg.text_len, cfg.text_dim, scale=0.5)(["a cat", ""])
    mask = NARROW_MASK
    core = make_wan_core(model, grid, plan, sp_impl=sp_impl)
    lat, skips = sample_unipc(core, torch.from_numpy(x0).to(device),
                              {"context": ctx.to(device)},
                              UniPCSchedule.create(len(mask), shift=5.0),
                              cache_cfg=make_config("wan2.1-t2v-1.3B", len(mask)),
                              guidance_scale=5.0, skip_mask_override=mask,
                              return_skips=True)
    if not np.array_equal(skips, mask):
        fail("narrow slice: realized skips differ from the override")
    return lat.float().cpu()


def check_narrow(label, got, want, launched, expected):
    """The narrow slice on the card against the CPU: bf16 activations through
    2 blocks and 6 steps vs f32, rounding of ~2^-8 per op, accumulated -> a
    few percent at most (tol 5e-2); and the launches expected."""
    if not bool(torch.isfinite(got).all()):
        fail(f"{label}: card latents are not finite")
    rel = float((got - want).norm() / want.norm())
    log(f"  {label}: rel L2 {rel:.3e} (tol 5e-2), max_abs_err "
        f"{float((got - want).abs().max()):.3e}, card launches {launched}")
    if rel > 5e-2:
        fail(f"{label}: card and CPU slices disagree")
    if launched != expected:
        fail(f"{label}: card launches differ from the expected {expected}")


def phase_card_vs_cpu(dev):
    """Returns the CPU's latents (phase 26 holds the sharded runs to them)."""
    log("phase 6: the slice on the card (kernels, bf16) vs the CPU (plain, f32)")
    reset_counts()
    got = narrow_wan_run(narrow_wan_model(dev, torch.bfloat16))
    launched = read_counts()
    want = narrow_wan_run(narrow_wan_model(torch.device("cpu"), torch.float32))
    runs = int((~NARROW_MASK.all(1)).sum())
    per_run = {k: n * NARROW_LAYERS // 30 for k, n in TRUNK_LAUNCHES.items()}
    check_narrow("one rank", got, want, launched,
                 wan_launches(per_run, runs, len(NARROW_MASK)))
    return want

# ---------------------------------------------------------------- Open-Sora
def record(rec, name, label, got, want, ms, pms, flops, moved, atol=4e-2, rtol=2e-2,
           library=None, tflops=H100_BF16_TFLOPS):
    """Compares a kernel's output with its plain version's, logs both times
    (and ``library``'s, ``(call, ms)``) and keeps the result. K7/K8's default
    tolerance: a flipped bf16 rounding of an intermediate (the GEMM operand,
    the pre-gate product, the gated value before the residual add) of
    magnitude < 8 moves an output by up to one ulp there, 2^-5."""
    err = compare(f"{name} [{label}]", got, want, atol=atol, rtol=rtol)
    log(f"  {name} [{label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms, tflops)}), "
        f"plain {pms:.3f} ms" + (f", {library[0]} {library[1]:.3f} ms" if library else ""))
    keep(rec, name, err, ms, pms, "loop", label, (flops, moved, tflops), library)


def k1_modes() -> dict:
    """K1's launches by softmax shift since the last ``reset_counts``."""
    from magcache_tpu_torch.ops import attention as A

    return dict(A.flash_attention_bshd.modes)


def k1_check(rec, title, label, q, k, v, fixed_max, big: bool = False):
    """K1 as ``attention()`` runs it at head dim D < 128: ``[B, S, H, D]``
    q/k/v zero-padded to 128, the kernel held against its plain version
    and timed beside SDPA at D. The bound counts the function, attention at
    D: 4·B·H·Sq·Skv·D operations and the unpadded q, k, v and output.
    ``big``: the plain version is timed by its one comparison call (CUDA
    events), not by a loop of its own, at shapes where it takes seconds."""
    from magcache_tpu_torch.ops import attention as A

    d = q.shape[-1]
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 128 - d)) for t in (q, k, v))
    kw = dict(scale=d ** -0.5, fixed_max=fixed_max)
    got = A.flash_attention_bshd(qp, kp, vp, **kw)
    want, plain_once = timed_once(lambda: A.flash_attention_bshd_plain(qp, kp, vp, **kw))
    err = compare(f"K1 flash_attention_bshd [{label}]", got, want, atol=2e-3, rtol=2e-2)
    del want
    ms = cuda_ms(lambda: A.flash_attention_bshd(qp, kp, vp, **kw), 5)
    pms = plain_once if big else cuda_ms(
        lambda: A.flash_attention_bshd_plain(qp, kp, vp, **kw), 1)
    lms = sdpa_ms(q, k, v, 5)
    b, sq, h, _ = q.shape
    flops = 4 * b * h * sq * k.shape[1] * d
    moved = nbytes(q, k, v, got[..., :d])
    log(f"  {title}: kernel {ms:.3f} ms ({rate(flops, moved, ms)} at head dim {d}), "
        f"plain {pms:.3f} ms, SDPA at head dim {d} {lms:.3f} ms")
    keep(rec, "flash_attention_bshd", err, ms, pms, "loop", label, (flops, moved),
         ("F.scaled_dot_product_attention", lms))


def os_inputs(dev, grid, seed):
    """Seeded STDiT3 inputs for a patch grid: 2 rows of latents, t = 900,
    the mock caption and fps 24."""
    from magcache_tpu_torch.models.text import MockTextEncoder

    gen = torch.Generator(device=dev).manual_seed(seed)
    t_len, gh, gw = grid
    x = torch.randn((2, t_len, 2 * gh, 2 * gw, 4), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"y": MockTextEncoder(300, 4096, scale=0.5)(["a boat", ""], device=dev),
            "fps": torch.full((2,), 24.0, device=dev)}
    return x, t, cond


def os_forward(model, grid, pixels, route, inputs, label, runs=1):
    """``runs`` timed forwards of ``model`` on ``route``; returns the last
    output (f32) after checking it is finite and shaped."""
    from magcache_tpu_torch.models.stdit3 import make_stdit3_core

    core = make_stdit3_core(model, grid, route=route, pixel_size=pixels)
    x, t, cond = inputs
    for run in range(runs):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, c = core.prepare(x, t, cond)
        out = core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        log(f"  {label} forward (call {run + 1}): {time.time() - t0:.3f} s, "
            f"{hidden.shape[1]} tokens x {hidden.shape[0]} rows")
    want = tuple(x.shape[:-1]) + (8,)
    if tuple(out.shape) != want or not bool(torch.isfinite(out).all()):
        fail(f"{label}: forward output {tuple(out.shape)} is not finite or misshapen")
    return out.float()


def check_forward_counts(label: str, runs: int, want: dict, routes: dict,
                         tiny: dict = NO_TINY_ROUTES, fixed=None) -> dict:
    """Fails unless the launches since the last ``reset_counts`` are
    ``want`` per forward over ``runs`` forwards, by route too, and (when
    ``fixed`` is given) K1's fixed-max launches per forward are ``fixed``;
    returns the launches."""
    counts = read_counts()
    per_run = {k: n // runs for k, n in counts.items()}
    log(f"  {label}: launches per forward {per_run}; K1 by shift {k1_modes()}")
    if per_run != want or any(n % runs for n in counts.values()):
        fail(f"{label}: launches per forward {per_run} != {want}")
    check_routes(label, runs, routes, tiny)
    if fixed is not None and k1_modes()["fixed"] != fixed * runs:
        fail(f"{label}: K1 fixed-max launches {k1_modes()['fixed']} != {fixed} x {runs}")
    return counts


def check_stdit3_linear_kernels(dev, rec, gen, S, rows=2, T=15, d=1152, H=16, L=300):
    """K7, K8 and K6 vs their plain versions at the shapes that STDiT3-XL/2
    gives them for ``rows`` rows of T latent frames of S tokens each."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    N = T * S

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K7: the spatial qkv projection (per-frame view, batch_repeat T) and
    # mlp1 with the gelu epilogue
    h = rnd(rows, N, d)
    sc, sh = rnd(rows, d, dtype=torch.float32, scale=0.1), rnd(rows, d, dtype=torch.float32, scale=0.1)
    for label, x, w, b, kw in (
            (f"qkv {rows * T}x{S}x{d} -> {3 * d}, batch_repeat {T}",
             h.reshape(rows * T, S, d), rnd(3 * d, d, scale=d ** -0.5),
             rnd(3 * d, scale=0.1), dict(batch_repeat=T)),
            (f"mlp1 {rows}x{N}x{d} -> {4 * d}, gelu", h, rnd(4 * d, d, scale=d ** -0.5),
             rnd(4 * d, scale=0.1), dict(act="gelu"))):
        got = P.lnmod_matmul(x, sc, sh, w, b, **kw)
        want = P.lnmod_matmul_plain(x, sc, sh, w, b, **kw)
        record(rec, "lnmod_matmul", label, got, want,
               cuda_ms(lambda: P.lnmod_matmul(x, sc, sh, w, b, **kw)),
               cuda_ms(lambda: P.lnmod_matmul_plain(x, sc, sh, w, b, **kw), 2),
               2 * x.shape[0] * x.shape[1] * d * w.shape[0], nbytes(x, w, b, got))
        # yardstick: cuBLAS on the already-modulated operand
        y = P.lnmod_operand_plain(x, sc, sh, batch_repeat=kw.get("batch_repeat", 1),
                                  dtype=w.dtype)
        log(f"    lnmod_matmul [{label}]: yardstick F.linear on the modulated input "
            f"{cuda_ms(lambda: torch.nn.functional.linear(y, w, b)):.3f} ms (GEMM only, "
            f"not the same function)")
        del got, want, y

    # K8: spatial proj + residual, temporal proj (gate row per S rows, no
    # residual), mlp2 + residual
    g = rnd(rows, d, dtype=torch.float32, scale=0.5)
    for label, x, w, r, kw in (
            (f"proj spatial {rows * T}x{S}x{d} + resid", rnd(rows * T, S, d),
             rnd(d, d, scale=d ** -0.5), h.reshape(rows * T, S, d), dict(batch_repeat=T)),
            (f"proj temporal {rows * S}x{T}x{d}, batch_repeat {S}", rnd(rows * S, T, d),
             rnd(d, d, scale=d ** -0.5), None, dict(batch_repeat=S, rows_out=T)),
            (f"mlp2 {rows}x{N}x{4 * d} + resid", rnd(rows, N, 4 * d),
             rnd(d, 4 * d, scale=(4 * d) ** -0.5), h, {})):
        b = rnd(d, scale=0.1)
        got = P.matmul_gated_residual(x, w, b, g, r, **kw)
        want = P.matmul_gated_residual_plain(x, w, b, g, r, **kw)
        record(rec, "matmul_gated_residual", label, got, want,
               cuda_ms(lambda: P.matmul_gated_residual(x, w, b, g, r, **kw)),
               cuda_ms(lambda: P.matmul_gated_residual_plain(x, w, b, g, r, **kw), 2),
               2 * x.shape[0] * x.shape[1] * x.shape[2] * d,
               nbytes(x, w, b, got, *([] if r is None else [r])))
        log(f"    matmul_gated_residual [{label}]: yardstick F.linear with bias "
            f"{cuda_ms(lambda: torch.nn.functional.linear(x, w, b)):.3f} ms (GEMM only, "
            f"not the same function)")
        del got, want, x

    # K6: cross-attention over the L-token caption, residual fused
    wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
    bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
    k, v = rnd(rows, L, d), rnd(rows, L, d)
    kw = dict(scale=(d // H) ** -0.5, true_d=d // H, residual=True)
    got = A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, **kw)
    want = A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H, **kw)
    label = f"{rows}x{N} x {L} keys, residual"
    record(rec, "fused_cross_attention", label, got, want,
           cuda_ms(lambda: A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, **kw)),
           cuda_ms(lambda: A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H, **kw), 2),
           4 * rows * N * d * d + 4 * rows * N * L * d, nbytes(h, wq, bq, k, v, wo, bo, got))
    # its three launches timed apart
    from magcache_tpu_torch.ops.gemm import gemm_launch

    b32, scale = bq.float(), kw["scale"]
    q = gemm_launch("q", h, wq, b32)
    o = A._cross_attention_launch(q, k, v, H, scale, L)
    stages = (("q projection", lambda: gemm_launch("q", h, wq, b32)),
              ("attention", lambda: A._cross_attention_launch(q, k, v, H, scale, L)),
              ("out-projection + residual",
               lambda: gemm_launch("o", o, wo, b32, epilogue="resid", resid=h)))
    log(f"    fused_cross_attention [{label}] by stage: " + ", ".join(
        f"{name} {cuda_ms(fn):.3f} ms" for name, fn in stages))


def phase_os_kernels(dev, rec):
    """K3, K5-K8 vs their plain versions at STDiT3-XL/2 480p x 51 shapes."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.rope import grouped_rope_tables

    log("phase 7: kernels vs plain at STDiT3-XL/2 480p 9:16 x 51 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows, T, S, d, H = 2, 15, 1590, 1152, 16
    N = T * S
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    check_stdit3_linear_kernels(dev, rec, gen, S)

    # K5: spatial (one group per frame) and temporal (groups of 15, RoPE)
    gains = (1.0 + rnd(H, 72, dtype=torch.float32, scale=0.1),
             1.0 + rnd(H, 72, dtype=torch.float32, scale=0.1))
    tabs = tuple(torch.from_numpy(a).to(dev) for a in grouped_rope_tables(T, T, 72))
    attn = dict(scale=72 ** -0.5, qk_gains=gains, true_d=72, eps=1e-6,
                fixed_max=A.QKNORM_FIXED_MAX)
    sdpa = "F.scaled_dot_product_attention (same q/k/v, without the qk-norm)"
    for label, qkv, kw, flops in (
            ("spatial 30x1590, group 1590", rnd(rows * T, S, 3 * d), dict(group=S),
             4 * rows * T * H * S * S * 72),
            ("temporal 47700, group 15, rope", rnd(1, rows * S * T, 3 * d),
             dict(group=T, rope_tables=tabs), 4 * rows * S * H * T * T * 72)):
        got = A.grouped_attention_fused_qkv(qkv, H, **kw, **attn)
        want = A.grouped_attention_fused_qkv_plain(qkv, H, **kw, **attn)
        group = kw["group"]
        q, k, v = A.split_qkv(qkv, H)
        heads = [t.reshape(-1, group, H, 72) for t in (q, k, v)]
        record(rec, "grouped_attention_fused_qkv", label, got, want,
               cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **kw, **attn)),
               cuda_ms(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **kw, **attn), 2),
               flops, nbytes(qkv, got), atol=1e-2, library=(sdpa, sdpa_ms(*heads, 20)))
        route = A.grouped_kernel(group, gains, kw.get("rope_tables"), A.QKNORM_FIXED_MAX)
        log(f"    K5 [{label}]: route {route!r}, {nbytes(qkv, got) / 1e9:.3f} GB of qkv "
            f"and output")
        if route == "prepass":
            # its two launches timed apart
            g = [t.contiguous() for t in gains]
            prepass = lambda: A._qk_norm_launch(q, k, g, 72 ** -0.5, 1e-6, group=group)
            qn, kn = prepass()
            body = lambda: A._grouped_tma_launch("K5", qn, kn, v, group, group, 1.0,
                                                 A.QKNORM_FIXED_MAX)
            log(f"    K5 [{label}] by stage: qk-norm pre-pass {cuda_ms(prepass):.3f} ms, "
                f"attention {cuda_ms(body):.3f} ms")
            del qn, kn
        del got, want, qkv, q, k, v, heads

    # K3 at the temporal block's shape (mod mode)
    h = rnd(rows, N, d)
    sc, sh = rnd(rows, d, dtype=torch.float32, scale=0.1), rnd(rows, d, dtype=torch.float32, scale=0.1)
    got = P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6)
    want = P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6)
    err = compare("layer_norm_mod [temporal mod, 2x23850x1152]", got, want,
                  atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6))
    log(f"  K3 [temporal mod]: kernel {ms:.3f} ms "
        f"({2 * h.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms")
    keep(rec, "layer_norm_mod", err, ms, pms, "loop", "temporal mod 2x23850x1152",
         elementwise_work(h, sc, sh))


def make_os_model(dev):
    from magcache_tpu_torch.models.stdit3 import STDIT3_XL_2, STDiT3Model

    cfg = dataclasses.replace(STDIT3_XL_2, dtype="bfloat16")
    t0 = time.time()
    model = STDiT3Model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  STDiT3-XL/2 bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def phase_os_forward(dev, model):
    log("phase 8: one full-shape forward, STDiT3-XL/2 480p 9:16 x 51, 2 rows")
    grid = (15, 30, 53)
    reset_counts()
    os_forward(model, grid, (480, 854), "packed", os_inputs(dev, grid, 8), "480p", runs=2)
    check_forward_counts("480p forward", 2, OS_TRUNK_LAUNCHES, OS_ROUTES)


def phase_os_requests(dev, model):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log(f"phase 9: requests through OpenSoraPipeline.generate, 480p 9:16 x "
        f"{OS_FRAMES} frames, {OS_STEPS} RFLOW steps, cfg 7.0")
    base = dict(resolution="480p", aspect_ratio="9:16", num_frames=OS_FRAMES,
                num_sampling_steps=OS_STEPS, cfg_scale=7.0, dtype="bfloat16")
    full = OpenSoraPipeline(OpenSoraPipelineConfig(**base), dev, model=model)
    cached = OpenSoraPipeline(OpenSoraPipelineConfig(use_magcache=True, **base),
                              dev, model=model)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(OS_STEPS, 1)
    ceiling = OS_STEPS / (OS_STEPS - int(sched.sum()))
    reset_counts()
    total = dict(NO_LAUNCHES)
    secs, full_latents = {}, None
    for label, pipe, want in (("full compute", full, np.zeros((OS_STEPS, 1), bool)),
                              ("MagCache opensora-v1.2", cached, sched)):
        before = read_counts()
        out = pipe.generate("A red sailboat glides across a calm bay at dawn.",
                            seed=3)
        launched = count_launches(before)
        lat = out.latents
        if tuple(lat.shape) != (1, 15, 60, 106, 4) or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, want):
            fail(f"{label}: realized skips differ from the schedule")
        runs = int((~out.skips.all(1)).sum())
        for k, got in launched.items():
            if got != OS_TRUNK_LAUNCHES[k] * runs:
                fail(f"{label}: {k} launched {got} times, expected "
                     f"{OS_TRUNK_LAUNCHES[k]} x {runs} trunk runs")
            total[k] += got
        secs[label] = out.timings["total_s"]
        full_latents = lat.float().cpu() if full_latents is None else full_latents
        log(f"  {label}: {secs[label]:.3f} s/video, {runs} of {OS_STEPS} "
            f"forwards computed, skipped steps "
            f"{np.flatnonzero(out.skips.any(1)).tolist()}, latents std "
            f"{float(lat.std()):.4f}")
    speedup = secs["full compute"] / secs["MagCache opensora-v1.2"]
    log(f"  speedup {speedup:.3f}x against a schedule ceiling of {ceiling:.3f}x "
        f"({OS_STEPS} / {OS_STEPS - int(sched.sum())} forwards)")
    if int(sched.sum()) != 18:
        fail(f"opensora-v1.2 skips {int(sched.sum())} of 30 steps, expected 18")
    log(f"  launches in phase 9: {total}")
    return total, full_latents


def _numpy_stdit3_tree(cfg, rng):
    """A random STDiT3 parameter tree in the JAX package's layout
    (depth-stacked blocks, ``w: [d_in, d_out]``)."""
    d, L = cfg.hidden, cfg.depth

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def group():
        g = {n: lin(d, w * d, L) for n, w in (("qkv", 3), ("proj", 1), ("cross_q", 1),
                                              ("cross_kv", 2), ("cross_o", 1),
                                              ("mlp1", cfg.mlp_ratio))}
        g["mlp2"] = lin(cfg.mlp_ratio * d, d, L)
        g["scale_shift"] = rng.standard_normal((L, 6, d)) / math.sqrt(d)
        g["q_norm"] = 1.0 + 0.1 * rng.standard_normal((L, cfg.head_dim))
        g["k_norm"] = 1.0 + 0.1 * rng.standard_normal((L, cfg.head_dim))
        return g

    return {"y_null": rng.standard_normal((cfg.caption_max_len, cfg.caption_dim)),
            "patch_embed": lin(cfg.patch_in, d),
            "t_embed": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "fps_embed": {"in": lin(cfg.freq_dim, d), "out": lin(d, d)},
            "t_block": lin(d, 6 * d),
            "y_embed": {"in": lin(cfg.caption_dim, d), "out": lin(d, d)},
            "spatial": group(), "temporal": group(),
            "final": {"scale_shift": rng.standard_normal((2, d)) / math.sqrt(d),
                      "out": lin(d, cfg.patch_out)}}


def phase_os_card_vs_cpu(dev):
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_euler
    from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
    from magcache_tpu_torch.models.stdit3 import (STDiT3Config, STDiT3Model,
                                                  make_stdit3_core)
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.schedulers.rflow import RFlowSchedule

    log("phase 10: the Open-Sora slice on the card (kernels, bf16) vs the CPU "
        "(plain, f32)")
    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20)
    grid = (5, 5, 8)                 # frames of 40 tokens (> 16), T = 5
    rng = np.random.default_rng(12)
    tree = _numpy_stdit3_tree(cfg, rng)
    x0 = rng.standard_normal((1, 5, 10, 16, 4)).astype(np.float32)
    y = MockTextEncoder(20, 64, scale=0.5)(["a red boat", ""])
    mask = np.array([0, 0, 1, 0, 1, 1, 0, 0], bool)[:, None]
    sch = RFlowSchedule.create(len(mask), use_timestep_transform=True, height=80,
                               width=128, num_frames=17)

    def combine(chunks):
        return chunks[1][..., :4] + 7.0 * (chunks[0][..., :4] - chunks[1][..., :4])

    outs = {}
    reset_counts()
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu", torch.device("cpu"), torch.float32)):
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
        model = STDiT3Model(c, device)
        model.load_state_dict(stdit3_params_from_numpy(tree, c, device))
        core = make_stdit3_core(model, grid, pixel_size=(80, 128))
        lat, skips = sample_euler(
            core, torch.from_numpy(x0).to(device),
            {"y": y.to(device), "fps": torch.full((2,), 24.0, device=device)},
            timesteps=sch.timesteps, dts=sch.dts(), lanes=2, combine_fn=combine,
            cache_cfg=make_config("opensora-v1.2", len(mask)),
            skip_mask_override=mask, return_skips=True)
        outs[name] = lat.float().cpu()
    got, want = outs["card"], outs["cpu"]
    if not bool(torch.isfinite(got).all()):
        fail("card latents are not finite")
    rel = float((got - want).norm() / want.norm())
    max_abs = float((got - want).abs().max())
    launched = read_counts()
    # bf16 activations through 2 block pairs and 5 computed steps vs f32:
    # rounding of ~2^-8 per op, accumulated -> a few percent at most
    log(f"  rel L2 {rel:.3e} (tol 5e-2), max_abs_err {max_abs:.3e}, "
        f"card launches {launched}")
    runs = int((~mask).sum())
    if rel > 5e-2 or any(launched[k] != 2 * n // 28 * runs
                         for k, n in OS_TRUNK_LAUNCHES.items()):
        fail("card and CPU slices disagree, or a kernel did not run as expected")


# --------------------------------------------------------------------- FLUX
def phase_flux_kernels(dev, rec):
    """K2 (head scope), K1 and K3 vs their plain versions at FLUX.1-dev
    1024x1024 shapes."""
    from magcache_tpu_torch.models.flux import FLUX_DEV, flux_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    log("phase 11: kernels vs plain at FLUX.1-dev 1024x1024 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(2468)
    H, D, d, L = 24, 128, 3072, FLUX_TXT
    n_img = FLUX_GRID[0] * FLUX_GRID[1]
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    cos_np, sin_np = flux_rope_tables(FLUX_DEV, L, *FLUX_GRID)
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    gain = 1.0 + rnd(D, dtype=torch.float32, scale=0.1)
    # K2 head scope on column slices of the fused projections, read in place
    # (same tolerance as the token scope: a flipped bf16 rounding of the
    # normed value moves an output by one ulp of its pair's largest element)
    for label, rows, width, col, tabs in (
            ("image q, 1x4096 rows of 9216", n_img, 3 * d, 0, (cos[L:], sin[L:])),
            ("text k, 1x512 rows of 9216", L, 3 * d, d, (cos[:L], sin[:L])),
            ("single-block q, 1x4608 rows of 21504", L + n_img, 7 * d, 0, (cos, sin))):
        x = rnd(1, rows, width, scale=2.0)[..., col:col + d]
        kw = dict(eps=1e-6, norm_scope="head")
        got = P.rms_norm_rope(x, gain, *tabs, H, **kw)
        want = P.rms_norm_rope_plain(x, gain, *tabs, H, **kw)
        err = compare(f"K2 rms_norm_rope [head scope, {label}]", got, want,
                      atol=3e-2, rtol=1.6e-2)
        # device times from a CUDA graph: a call's host dispatch (~0.05 ms)
        # outlasts the kernel
        ms = cuda_graph_ms(lambda: P.rms_norm_rope(x, gain, *tabs, H, **kw))
        pms = cuda_graph_ms(lambda: P.rms_norm_rope_plain(x, gain, *tabs, H, **kw))
        call_ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, *tabs, H, **kw))
        log(f"  K2h [{label}]: kernel {ms:.4f} ms ({2 * rows * d * 2 / ms / 1e6:.0f} "
            f"GB/s), plain {pms:.4f} ms; {call_ms:.4f} ms per back-to-back "
            f"wrapper call")
        keep(rec, "rms_norm_rope_head", err, ms, pms, "graph", label,
             elementwise_work(got, gain, *tabs))
        del x, got, want

    # K1 over the joint [txt; img] sequence with the static shift
    S = L + n_img
    q, k, v = rnd(1, S, H, D), rnd(1, S, H, D), rnd(1, S, H, D)
    got = A.flash_attention_bshd(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
    want = A.flash_attention_bshd_plain(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
    err = compare("K1 flash_attention_bshd [joint 1x4608x24x128, fixed_max=16]",
                  got, want, atol=2e-3, rtol=2e-2)
    ms = cuda_ms(lambda: A.flash_attention_bshd(q, k, v, fixed_max=16.0), 10)
    pms = cuda_ms(lambda: A.flash_attention_bshd_plain(q, k, v, fixed_max=16.0), 2)
    lms = sdpa_ms(q, k, v, 10)
    log(f"  K1 [joint 4608]: kernel {ms:.3f} ms "
        f"({rate(4 * H * S * S * D, 4 * nbytes(q), ms)}), plain {pms:.3f} ms, "
        f"SDPA {lms:.3f} ms")
    keep(rec, "flash_attention_bshd", err, ms, pms, "loop", "joint 1x4608x24x128",
         (4 * H * S * S * D, 4 * nbytes(q)), ("F.scaled_dot_product_attention", lms))
    del q, k, v, got, want

    # K3 mod at the double block's image stream
    x = rnd(1, n_img, d, scale=2.0)
    sc, sh = rnd(1, 1, d, dtype=torch.float32, scale=0.3), rnd(1, 1, d, dtype=torch.float32, scale=0.3)
    got = P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6)
    want = P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6)
    err = compare("K3 layer_norm_mod [mod, 1x4096x3072]", got, want, atol=3e-2,
                  rtol=1.6e-2)
    ms = cuda_graph_ms(lambda: P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_graph_ms(lambda: P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6))
    call_ms = cuda_ms(lambda: P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6))
    log(f"  K3 [mod 4096x3072]: kernel {ms:.4f} ms "
        f"({2 * x.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms; "
        f"{call_ms:.4f} ms per back-to-back wrapper call")
    keep(rec, "layer_norm_mod", err, ms, pms, "graph", "mod 1x4096x3072",
         elementwise_work(x, sc, sh))


def make_flux_model(dev):
    from magcache_tpu_torch.models.flux import FLUX_DEV, FluxModel

    cfg = dataclasses.replace(FLUX_DEV, dtype="bfloat16")
    t0 = time.time()
    model = FluxModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  FLUX.1-dev bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    return model


def _flux_cond(dev, prompt, guidance=3.5):
    from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder

    return {"txt": MockTextEncoder(FLUX_TXT, 4096, scale=0.5)([prompt], device=dev),
            "vec": MockPooledEncoder(768)([prompt], device=dev),
            "guidance": torch.full((1,), guidance, device=dev)}


def _cond_latents(dev):
    """Seeded packed Kontext conditioning latents ``[1, 4096, 64]``."""
    gen = torch.Generator(device=dev).manual_seed(9)
    return torch.randn((1, FLUX_GRID[0] * FLUX_GRID[1], 64), generator=gen, device=dev)


def phase_flux_forward(dev, model):
    from magcache_tpu_torch.models.flux import make_flux_core

    log("phase 12: one full-shape forward, FLUX.1-dev 1024x1024 (4,096 image + "
        "512 text tokens), and one Kontext forward (8,704 tokens)")
    gen = torch.Generator(device=dev).manual_seed(10)
    x = torch.randn((1, 4096, 64), generator=gen, device=dev)
    t = torch.full((1,), 900.0, device=dev)
    for kontext in (False, True):
        core = make_flux_core(model, FLUX_TXT, *FLUX_GRID, kontext=kontext)
        cond = _flux_cond(dev, "a red fox in fresh snow")
        if kontext:
            cond["kontext"] = _cond_latents(dev)
        name = "Kontext" if kontext else "t2i"
        reset_counts()
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.time()
            hidden, c = core.prepare(x, t, cond)
            out = core.head(core.trunk(hidden, c), c)
            torch.cuda.synchronize()
            log(f"  {name} forward ({run} call): {time.time() - t0:.3f} s, "
                f"{hidden.shape[1] + FLUX_TXT} tokens in the joint attention")
        if tuple(out.shape) != (1, 4096, 64) or not bool(torch.isfinite(out).all()):
            fail(f"{name} forward output {tuple(out.shape)} is not finite or misshapen")
        per_run = {k: n // 2 for k, n in read_counts().items()}
        want = dict(FLUX_TRUNK_LAUNCHES, layer_norm_mod=FLUX_TRUNK_LAUNCHES["layer_norm_mod"] + 1)
        log(f"  {name} output {tuple(out.shape)} finite, std "
            f"{float(out.float().std()):.4f}; launches per forward {per_run}")
        if per_run != want:
            fail(f"{name}: launches per forward {per_run} != {want}")


def phase_flux_requests(dev, model):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig

    log(f"phase 13: requests through FluxPipeline.generate, 1024x1024, "
        f"{FLUX_STEPS} Euler steps (flux-dev guidance 3.5, Kontext 2.5)")
    reset_counts()
    total = dict(NO_LAUNCHES)
    cond_lat = _cond_latents(dev)
    for key, guidance, skipped in (("flux-dev", 3.5, 19), ("flux-kontext-dev", 2.5, 14)):
        base = dict(model=key, num_inference_steps=FLUX_STEPS, guidance=guidance)
        full = FluxPipeline(FluxPipelineConfig(**base), dev, model=model)
        cached = FluxPipeline(FluxPipelineConfig(use_magcache=True, **base), dev,
                              model=model)
        sched = compute_skip_schedule(cached._cache_cfg()).reshape(FLUX_STEPS, 1)
        if int(sched.sum()) != skipped:
            fail(f"{key} skips {int(sched.sum())} of {FLUX_STEPS} steps, expected {skipped}")
        gen = dict(cond_latents=cond_lat) if "kontext" in key else {}
        secs = {}
        for label, pipe, want in (("full compute", full, np.zeros((FLUX_STEPS, 1), bool)),
                                  (f"MagCache {key}", cached, sched)):
            before = read_counts()
            out = pipe.generate("A red fox sits in fresh snow at dawn.", seed=3, **gen)
            launched = count_launches(before)
            lat = out.latents
            if tuple(lat.shape) != (1, 4096, 64) or not bool(torch.isfinite(lat).all()):
                fail(f"{key} {label}: latents {tuple(lat.shape)} not finite or misshapen")
            if not np.array_equal(out.skips, want):
                fail(f"{key} {label}: realized skips differ from the schedule")
            runs = int((~out.skips.all(1)).sum())
            for k, got in launched.items():
                exp = FLUX_TRUNK_LAUNCHES[k] * runs + (FLUX_STEPS if k == "layer_norm_mod" else 0)
                if got != exp:
                    fail(f"{key} {label}: {k} launched {got} times, expected "
                         f"{FLUX_TRUNK_LAUNCHES[k]} x {runs} trunk runs (+ the head's "
                         f"K3 per step)")
                total[k] += got
            secs[label] = out.timings["total_s"]
            log(f"  {key} {label}: {secs[label]:.3f} s/image, {runs} of {FLUX_STEPS} "
                f"forwards computed, skipped steps "
                f"{np.flatnonzero(out.skips.any(1)).tolist()}, latents std "
                f"{float(lat.std()):.4f}")
        ceiling = FLUX_STEPS / (FLUX_STEPS - skipped)
        log(f"  {key}: speedup {secs['full compute'] / secs[f'MagCache {key}']:.3f}x "
            f"against a schedule ceiling of {ceiling:.3f}x")
    log(f"  launches in phase 13: {total}")
    return total


def _numpy_flux_tree(cfg, rng):
    """A random FLUX parameter tree in the JAX package's layout
    (depth-stacked blocks, ``w: [d_in, d_out]``)."""
    d, L2, L1, mlp = cfg.hidden, cfg.depth_double, cfg.depth_single, cfg.mlp_dim

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def emb(d_in):
        return {"in": lin(d_in, d), "out": lin(d, d)}

    double = {}
    for s in ("img", "txt"):
        double.update({f"{s}_mod": lin(d, 6 * d, L2), f"{s}_qkv": lin(d, 3 * d, L2),
                       f"{s}_proj": lin(d, d, L2), f"{s}_mlp1": lin(d, mlp, L2),
                       f"{s}_mlp2": lin(mlp, d, L2),
                       f"{s}_qk_scale": 1.0 + 0.1 * rng.standard_normal((L2, 2, cfg.head_dim))})
    single = {"mod": lin(d, 3 * d, L1), "lin1": lin(d, 3 * d + mlp, L1),
              "lin2": lin(d + mlp, d, L1),
              "qk_scale": 1.0 + 0.1 * rng.standard_normal((L1, 2, cfg.head_dim))}
    return {"img_in": lin(cfg.in_channels, d), "txt_in": lin(cfg.text_dim, d),
            "time_in": emb(cfg.time_embed_dim), "vector_in": emb(cfg.vec_dim),
            "guidance_in": emb(cfg.time_embed_dim), "double": double,
            "single": single, "final_mod": lin(d, 2 * d),
            "final_out": lin(d, cfg.in_channels)}


def phase_flux_card_vs_cpu(dev):
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_euler
    from magcache_tpu_torch.models.convert import flux_params_from_numpy
    from magcache_tpu_torch.models.flux import FluxConfig, FluxModel, make_flux_core
    from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder
    from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule

    log("phase 14: the FLUX slice on the card (kernels, bf16) vs the CPU "
        "(plain, f32)")
    cfg = FluxConfig(hidden=256, heads=2, depth_double=2, depth_single=2,
                     text_dim=64, vec_dim=32, time_embed_dim=64)
    txt_len, grid = 48, (8, 12)          # 48 + 96 = 144 joint tokens: K1 runs
    rng = np.random.default_rng(13)
    tree = _numpy_flux_tree(cfg, rng)
    x0 = rng.standard_normal((1, grid[0] * grid[1], cfg.in_channels)).astype(np.float32)
    cond = {"txt": MockTextEncoder(txt_len, 64, scale=0.5)(["a red fox"]),
            "vec": MockPooledEncoder(32)(["a red fox"]),
            "guidance": torch.full((1,), 3.5)}
    mask = np.array([0, 0, 1, 0, 1, 1, 0, 0], bool)[:, None]
    sch = FlowMatchSchedule.create(len(mask), mu=FlowMatchSchedule.flux_mu(96),
                                   linspace_endpoint=True)
    outs = {}
    reset_counts()
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu", torch.device("cpu"), torch.float32)):
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[1])
        model = FluxModel(c, device)
        model.load_state_dict(flux_params_from_numpy(tree, c, device))
        core = make_flux_core(model, txt_len, *grid)
        lat, skips = sample_euler(
            core, torch.from_numpy(x0).to(device),
            {k: v.to(device) for k, v in cond.items()},
            timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
            cache_cfg=make_config("flux-dev", len(mask)),
            skip_mask_override=mask, return_skips=True)
        outs[name] = lat.float().cpu()
    got, want = outs["card"], outs["cpu"]
    if not bool(torch.isfinite(got).all()):
        fail("card latents are not finite")
    rel = float((got - want).norm() / want.norm())
    max_abs = float((got - want).abs().max())
    launched = read_counts()
    # bf16 activations through 2 + 2 blocks and 5 computed steps vs f32:
    # rounding of ~2^-8 per op, accumulated -> a few percent at most
    log(f"  rel L2 {rel:.3e} (tol 5e-2), max_abs_err {max_abs:.3e}, "
        f"card launches {launched}")
    runs = int((~mask).sum())
    # per trunk run of 2 double + 2 single blocks; the head's K3 runs every step
    want_launches = dict(NO_LAUNCHES, flash_attention_bshd=4 * runs,
                         rms_norm_rope_head=12 * runs,
                         layer_norm_mod=10 * runs + len(mask))
    if rel > 5e-2 or launched != want_launches:
        fail(f"card and CPU slices disagree, or launches {launched} != {want_launches}")

# ---------------------------------------------------------- Open-Sora 720p
def phase_os720_kernels(dev, rec):
    """K1q vs its plain version at one 720p spatial block's shape, then K5
    and K3 at the 720p temporal block's shapes and K6-K8 at the 720p
    blocks' shapes (frames of 3,600 tokens: 16 ragged rows per 64-row tile,
    a gate row every 3,600 rows)."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops.rope import grouped_rope_tables

    log("phase 15: K1q, K3 and K5-K8 vs plain at STDiT3-XL/2 720p 9:16 x 51 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(1357)
    frames, (_, gh, gw), H, D = 2 * 15, OS720_GRID, 16, 72
    S = gh * gw
    qkv = torch.randn((frames, S, 3 * H * D), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (part.unflatten(-1, (H, D)) for part in qkv.chunk(3, dim=-1))
    gains = tuple(1.0 + 0.1 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
    kw = dict(scale=D ** -0.5, qk_gains=gains, true_d=D, eps=1e-6,
              fixed_max=A.QKNORM_FIXED_MAX)
    got = A.flash_attention_bshd(q, k, v, **kw)
    want = A.flash_attention_bshd_plain(q, k, v, **kw)
    # as K1: the same rounding points (q normed and scaled in f32, rounded
    # once; k rounded; p rounded before PV), only f32 summation orders and
    # rsqrt's last bits differ -> a bf16 ulp or two of the output
    label = "qk-norm, 30x3600x16x72 views of [30, 3600, 3456]"
    err = compare(f"K1q flash_attention_bshd [{label}]", got, want, atol=2e-3, rtol=2e-2)
    dense = A.flash_attention_bshd(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    if not torch.equal(dense, got):
        fail("K1q: strided views and contiguous copies of q/k/v give different outputs")
    del want, dense
    ms = cuda_ms(lambda: A.flash_attention_bshd(q, k, v, **kw), 10)
    pms = cuda_ms(lambda: A.flash_attention_bshd_plain(q, k, v, **kw), 2)
    lms = sdpa_ms(q, k, v, 10)
    flops = 4 * frames * H * S * S * D
    moved = nbytes(q, k, v, got, *gains)
    log(f"  K1q [720p block]: kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
        f"{flops / ms / 1e9 / H100_BF16_TFLOPS:.1%} of {H100_BF16_TFLOPS:.0f}), plain "
        f"{pms:.3f} ms, SDPA without the norm {lms:.3f} ms")
    # its two launches timed apart
    g = [t.reshape(-1, D).expand(H, D).contiguous() for t in gains]
    qn, kn = A._qk_norm_launch(q, k, g, D ** -0.5, 1e-6)
    log(f"    K1q by stage: qk-norm pre-pass "
        f"{cuda_ms(lambda: A._qk_norm_launch(q, k, g, D ** -0.5, 1e-6), 10):.3f} ms, "
        f"attention {cuda_ms(lambda: A._qknorm_attention_launch(qn, kn, v, S, A.QKNORM_FIXED_MAX), 10):.3f} ms")
    del qn, kn
    keep(rec, "flash_attention_bshd_qknorm", err, ms, pms, "loop", label, (flops, moved),
         ("F.scaled_dot_product_attention (same q/k/v, without the qk-norm)", lms))
    del qkv, q, k, v, got

    # K5 (temporal: 7,200 locations x 2 rows, groups of 15, RoPE) and K3
    # (temporal mod) at the 720p shapes, tolerances as in phase 7
    T, d = 15, H * D
    tabs = tuple(torch.from_numpy(a).to(dev) for a in grouped_rope_tables(T, T, D))
    tkw = dict(kw, group=T, rope_tables=tabs)
    qkv = torch.randn((1, 2 * S * T, 3 * d), generator=gen, device=dev).to(torch.bfloat16)
    label = "temporal 108000, group 15, rope"
    got = A.grouped_attention_fused_qkv(qkv, H, **tkw)
    err = compare(f"grouped_attention_fused_qkv [{label}]", got,
                  A.grouped_attention_fused_qkv_plain(qkv, H, **tkw),
                  atol=1e-2, rtol=2e-2)
    ms = cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **tkw))
    pms = cuda_ms(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **tkw), 2)
    lms = sdpa_ms(*(t.reshape(-1, T, H, D) for t in A.split_qkv(qkv, H)), 20)
    log(f"  K5 [{label}]: kernel {ms:.3f} ms ({nbytes(qkv, got) / ms / 1e9:.2f} TB/s, route "
        f"'stream'), plain {pms:.3f} ms, SDPA without the norm {lms:.3f} ms")
    keep(rec, "grouped_attention_fused_qkv", err, ms, pms, "loop", label,
         (4 * 2 * S * H * T * T * D, nbytes(qkv, got)))
    del qkv, got
    h = torch.randn((2, T * S, d), generator=gen, device=dev).to(torch.bfloat16)
    sc, sh = (0.1 * torch.randn((2, d), generator=gen, device=dev) for _ in range(2))
    got = P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6)
    err = compare("layer_norm_mod [temporal mod, 2x54000x1152]", got,
                  P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6),
                  atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6))
    log(f"  K3 [temporal mod 720p]: kernel {ms:.3f} ms "
        f"({2 * h.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms")
    keep(rec, "layer_norm_mod", err, ms, pms, "loop", "temporal mod 2x54000x1152",
         elementwise_work(h, sc, sh))
    del h, got
    check_stdit3_linear_kernels(dev, rec, gen, S)


def phase_os720_forward(dev, model):
    log("phase 16: one full-shape forward, STDiT3-XL/2 720p 9:16 x 51, 2 rows")
    grid = (15,) + OS720_GRID[1:]
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    os_forward(model, grid, (720, 1280), "packed", os_inputs(dev, grid, 16), "720p", runs=2)
    log(f"  peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check_forward_counts("720p forward", 2, OS720_TRUNK_LAUNCHES, OS720_ROUTES)


def _scratch_dir() -> str:
    """``build/chip_smoke`` in the checkout (listed in .gitignore)."""
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chip_smoke")
    os.makedirs(path, exist_ok=True)
    return path


def phase_os720_requests(dev, model):
    import os

    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log(f"phase 17: requests through OpenSoraPipeline.generate, 720p 9:16 x "
        f"{OS720_FRAMES} frames, {OS_STEPS} RFLOW steps, cfg 7.0")
    base = dict(resolution="720p", aspect_ratio="9:16", num_frames=OS720_FRAMES,
                num_sampling_steps=OS_STEPS, cfg_scale=7.0, dtype="bfloat16")
    full = OpenSoraPipeline(OpenSoraPipelineConfig(**base), dev, model=model)
    cached = OpenSoraPipeline(OpenSoraPipelineConfig(use_magcache=True, **base),
                              dev, model=model)
    shape = (1,) + cached.latent_shape
    if shape != (1, 5, 90, 160, 4) or cached.grid != OS720_GRID:
        fail(f"720p x {OS720_FRAMES} latents {shape}, grid {cached.grid}")
    sched = cached.skip_mask_for()
    if int(sched.sum()) != 18:
        fail(f"opensora-v1.2 skips {int(sched.sum())} of 30 steps, expected 18")
    # latent frame 0 pinned to a seeded reference (edit ratio 0), the last
    # frame pasted from it at edit ratio 0.5 (re-noised once t <= 500)
    ref = torch.randn((1,) + shape[2:], generator=torch.Generator().manual_seed(17))
    ref_path = os.path.join(_scratch_dir(), "ref_720p.npy")
    np.save(ref_path, ref.numpy())
    masked = dict(ms="0,0,0,0,1,0;0,0,0,4,1,0.5", refs=ref_path, align=None)
    requests = [("full compute", full, {}, np.zeros((OS_STEPS, 1), bool),
                 OS720_TRUNK_LAUNCHES),
                ("MagCache opensora-v1.2", cached, {}, sched, OS720_TRUNK_LAUNCHES),
                ("MagCache, mask strategy", cached, masked, sched, OS720_MASKED_LAUNCHES)]
    reset_counts()
    total = dict(NO_LAUNCHES)
    secs = {}
    for label, pipe, kw, want, per_run in requests:
        before = read_counts()
        out = pipe.generate("A red sailboat glides across a calm bay at dawn.", seed=3,
                            **kw)
        launched = count_launches(before)
        lat = out.latents
        if tuple(lat.shape) != shape or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, want):
            fail(f"{label}: realized skips differ from the schedule")
        if kw and not torch.equal(lat[0, 0].cpu(), ref[0]):
            fail(f"{label}: the pinned frame moved off its reference")
        runs = int((~out.skips.all(1)).sum())
        for k, got in launched.items():
            if got != per_run[k] * runs:
                fail(f"{label}: {k} launched {got} times, expected {per_run[k]} x "
                     f"{runs} trunk runs")
            total[k] += got
        secs[label] = out.timings["total_s"]
        log(f"  {label}: {secs[label]:.3f} s/video, {runs} of {OS_STEPS} forwards "
            f"computed, K1q launches {launched['flash_attention_bshd_qknorm']}, "
            f"latents std {float(lat.std()):.4f}")
    ceiling = OS_STEPS / (OS_STEPS - int(sched.sum()))
    log(f"  speedup {secs['full compute'] / secs['MagCache opensora-v1.2']:.3f}x "
        f"against a schedule ceiling of {ceiling:.3f}x; the masked request "
        f"{secs['MagCache, mask strategy']:.3f} s")
    log(f"  launches in phase 17: {total}")
    return total


def phase_os720_card_vs_cpu(dev):
    import os

    from magcache_tpu_torch.models.convert import stdit3_params_from_numpy
    from magcache_tpu_torch.models.stdit3 import STDiT3Config, STDiT3Model
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log("phase 18: the Open-Sora slice with frames of 2,304 tokens (K1q), a pinned "
        "reference and loop=2, on the card (kernels, bf16) vs the CPU (plain, f32)")
    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20)
    rng = np.random.default_rng(18)
    tree = _numpy_stdit3_tree(cfg, rng)
    ref_path = os.path.join(_scratch_dir(), "ref_narrow.npy")
    np.save(ref_path, rng.standard_normal((1, 96, 96, 4)).astype(np.float32))
    # 768x768 pixels, 8 frames -> 2 latent frames of 48 x 48 = 2,304 tokens
    base = dict(height=768, width=768, num_frames=8, num_sampling_steps=8,
                cfg_scale=7.0, caption_len=20)
    requests = (("plain", {}),
                ("pinned reference, loop=2", dict(ms="0,0,0,0,1,0", refs=ref_path, loop=2,
                                                  condition_frame_length=1, align=None)))
    per_run = {"plain": OS720_TRUNK_LAUNCHES,
               "pinned reference, loop=2": OS720_MASKED_LAUNCHES}
    outs = {}
    reset_counts()
    for name, device, dtype in (("card", dev, "bfloat16"), ("cpu", torch.device("cpu"),
                                                             "float32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = STDiT3Model(c, device)
        model.load_state_dict(stdit3_params_from_numpy(tree, c, device))
        pipe = OpenSoraPipeline(OpenSoraPipelineConfig(dtype=dtype, **base), device,
                                model=model)
        for label, kw in requests:
            out = pipe.generate("a red boat", seed=4, **kw)
            outs[name, label] = (out.latents.float().cpu(), out.skips)
        if name == "card":
            launched = read_counts()
    want_launches = dict(NO_LAUNCHES)
    for label, _ in requests:
        (got, skips), (want, cpu_skips) = outs["card", label], outs["cpu", label]
        if not bool(torch.isfinite(got).all()) or not np.array_equal(skips, cpu_skips):
            fail(f"{label}: card latents not finite, or skips differ from the CPU's")
        rel = float((got - want).norm() / want.norm())
        runs = int((~skips.all(1)).sum())
        for k, n in per_run[label].items():
            want_launches[k] += n // 14 * runs      # 2 of 28 block pairs
        # bf16 activations through 2 block pairs and the computed steps vs
        # f32: rounding of ~2^-8 per op, accumulated -> a few percent at most
        log(f"  {label}: latents {tuple(got.shape)}, {runs} trunk runs, rel L2 "
            f"{rel:.3e} (tol 5e-2), max_abs_err {float((got - want).abs().max()):.3e}")
        if rel > 5e-2:
            fail(f"{label}: card and CPU slices disagree")
    log(f"  card launches {launched}")
    if launched != want_launches:
        fail(f"card launches {launched} != {want_launches}")


# -------------------------------------------------------------------- Latte
def check_tiny_route(route: str, call):
    """``call()``'s result; fails unless it launched K9 once, on ``route``."""
    from magcache_tpu_torch.ops import tiny_attention as TA

    before = dict(TA.tiny_temporal_attention.routes)
    out = call()
    got = {k: n - before[k] for k, n in TA.tiny_temporal_attention.routes.items()}
    if got != dict(NO_TINY_ROUTES, **{route: 1}):
        fail(f"K9 launched by route {got}, not once on {route!r}")
    return out


def phase_latte_kernels(dev, rec):
    """K5r, K4, K9, K1 at padded head dim, and K3, K6-K8 vs their plain
    versions at Latte-1 512x512 x 16 shapes (2 rows of 16 frames x 1,024
    tokens, bf16); then K4 and K9 with gains and RoPE at the STDiT3 480p
    temporal shape."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.ops import tiny_attention as TA
    from magcache_tpu_torch.ops.rope import rope_freqs_1d

    log("phase 19: kernels vs plain at Latte-1 512x512 x 16 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(1919)
    rows, (T, gh, gw), H, D = 2, LATTE_GRID, 16, 72
    S, d = gh * gw, H * D
    sdpa = "F.scaled_dot_product_attention"

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def heads(qkv, groups, group):
        """q, k, v ``[groups, group, H, 72]`` views of a fused projection."""
        return qkv.reshape(groups, group, 3, H, D).unbind(2)

    def valid_keys(qkv_heads, gvalid):
        """q, and k and v cut to their first ``gvalid`` positions."""
        q, k, v = qkv_heads
        return q, k[:, :gvalid], v[:, :gvalid]

    # K5r (tolerances of the K5 records): spatial, one group per frame, and
    # temporal, groups of 16 frames; SDPA on the same q/k/v computes the same
    # function (no qk-norm), over the frames as the batch with k and v cut to
    # the valid keys where group_valid < group
    for label, qkv, group, gvalid in (
            (f"spatial {rows * T}x{S}, group {S}", rnd(rows * T, S, 3 * d), S, S),
            ("8x1590, group 1590, 1400 valid keys", rnd(8, 1590, 3 * d), 1590, 1400),
            # last: K4 and K9 below take this projection
            (f"temporal {rows * S * T} rows, group {T}", rnd(1, rows * S * T, 3 * d), T, T)):
        groups = qkv.numel() // (3 * d * group)
        kw = dict(group=group, group_valid=gvalid, scale=D ** -0.5)
        got = A.grouped_attention_fused_qkv(qkv, H, **kw)
        want = A.grouped_attention_fused_qkv_plain(qkv, H, **kw)
        record(rec, "grouped_attention_fused_qkv_rowmax", label, got, want,
               cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **kw)),
               cuda_ms(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **kw), 1),
               4 * groups * H * group * gvalid * D, nbytes(qkv, got),
               library=(sdpa, sdpa_ms(*valid_keys(heads(qkv, groups, group), gvalid), 20)))
        del got, want

    # K4 (q/k/v views of the projection) and K9 (the projection) at the
    # temporal shape, no norm or RoPE: Latte's unpacked routes
    tq, tk, tv = heads(qkv, rows * S, T)
    flat = [t.reshape(1, rows * S * T, H, D) for t in (tq, tk, tv)]
    kw = dict(group=T, scale=D ** -0.5)
    got = A.grouped_flash_attention_bshd(*flat, **kw)
    want = A.grouped_flash_attention_bshd_plain(*flat, **kw)
    flops, moved = 4 * rows * S * H * T * T * D, nbytes(qkv, got)
    lib = (sdpa, sdpa_ms(tq, tk, tv, 20))
    record(rec, "grouped_flash_attention_bshd", f"temporal {rows * S * T} rows, group {T}",
           got, want, cuda_ms(lambda: A.grouped_flash_attention_bshd(*flat, **kw)),
           cuda_ms(lambda: A.grouped_flash_attention_bshd_plain(*flat, **kw), 1),
           flops, moved, library=lib)
    x3 = qkv.reshape(rows * S, T, 3 * d)
    got = check_tiny_route("stream", lambda: TA.tiny_temporal_attention(
        x3, None, None, None, None, H, mode="vpu"))
    want = TA.tiny_temporal_attention_plain(x3, None, None, None, None, H)
    # f32 throughout, one rounding at the store: a bf16 ulp of the output
    ms = cuda_ms(lambda: TA.tiny_temporal_attention(x3, None, None, None, None, H, mode="vpu"))
    record(rec, "tiny_temporal_attention", f"temporal {rows * S}x{T}, route stream", got,
           want, ms, cuda_ms(lambda: TA.tiny_temporal_attention_plain(x3, None, None, None,
                                                                      None, H), 1),
           flops, moved, atol=1e-2, library=lib, tflops=H100_F32_TFLOPS)
    log(f"    K9 route stream: {moved / ms / 1e9:.2f} TB/s")
    del qkv, x3, got, want, flat, tq, tk, tv

    # K4 and K9 with gains and RoPE at the STDiT3-XL/2 480p temporal shape
    # (3,180 groups of 15); SDPA without the norm is not the same function
    Ts, Rs = 15, 2 * 1590
    qkv = rnd(Rs, Ts, 3 * d)
    gains = tuple(1.0 + 0.1 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
    cos, sin = (torch.from_numpy(a).to(dev) for a in rope_freqs_1d(np.arange(Ts), D))
    q, k, v = heads(qkv, Rs, Ts)
    flat = [t.reshape(1, Rs * Ts, H, D) for t in (q, k, v)]
    kw = dict(group=Ts, scale=D ** -0.5, qk_gains=gains, rope_tables=(cos, sin),
              fixed_max=A.QKNORM_FIXED_MAX)
    got = A.grouped_flash_attention_bshd(*flat, **kw)
    want = A.grouped_flash_attention_bshd_plain(*flat, **kw)
    flops, moved = 4 * Rs * H * Ts * Ts * D, nbytes(qkv, got, *gains, cos, sin)
    record(rec, "grouped_flash_attention_bshd", f"STDiT3 480p temporal {Rs * Ts} rows, "
           f"group {Ts}, qk-norm + RoPE", got, want,
           cuda_ms(lambda: A.grouped_flash_attention_bshd(*flat, **kw)),
           cuda_ms(lambda: A.grouped_flash_attention_bshd_plain(*flat, **kw), 1),
           flops, moved)
    got = check_tiny_route("stream", lambda: TA.tiny_temporal_attention(
        qkv, *gains, cos, sin, H, mode="vpu"))
    want = TA.tiny_temporal_attention_plain(qkv, *gains, cos, sin, H)
    ms = cuda_ms(lambda: TA.tiny_temporal_attention(qkv, *gains, cos, sin, H, mode="vpu"))
    record(rec, "tiny_temporal_attention", f"STDiT3 480p temporal {Rs}x{Ts}, qk-norm + "
           f"RoPE, route stream", got, want, ms,
           cuda_ms(lambda: TA.tiny_temporal_attention_plain(qkv, *gains, cos, sin, H), 1),
           flops, moved, atol=1e-2, tflops=H100_F32_TFLOPS)
    log(f"    K9 route stream: {moved / ms / 1e9:.2f} TB/s")
    log(f"    SDPA on the same q/k/v without the norm: {sdpa_ms(q, k, v, 20):.3f} ms")
    del qkv, q, k, v, flat, got, want

    # K1 with the running max at head dim 72 zero-padded to 128, as
    # attention() runs it: spatial self-attention and cross-attention
    for label, sq, skv, b in ((f"running max, Latte spatial {rows * T}x{S}x{H}x72 -> 128",
                               S, S, rows * T),
                              (f"running max, Latte cross {rows}x{T * S} x {LATTE_CAP} "
                               f"keys, 72 -> 128", T * S, LATTE_CAP, rows)):
        k1_check(rec, f"K1 [{label}]", label, rnd(b, sq, H, D), rnd(b, skv, H, D),
                 rnd(b, skv, H, D), None)

    # K3 (temporal mod), then K6 over 120 caption keys, K7 and K8 at the
    # Latte blocks' shapes
    h = rnd(rows, T * S, d)
    sc, sh = rnd(rows, d, dtype=torch.float32, scale=0.1), rnd(rows, d, dtype=torch.float32, scale=0.1)
    got = P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6)
    err = compare(f"layer_norm_mod [Latte temporal mod, {rows}x{T * S}x{d}]", got,
                  P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6),
                  atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(h, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(h, scale=sc, shift=sh, eps=1e-6))
    log(f"  K3 [Latte temporal mod]: kernel {ms:.3f} ms "
        f"({2 * h.numel() * 2 / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms")
    keep(rec, "layer_norm_mod", err, ms, pms, "loop", f"Latte mod {rows}x{T * S}x{d}",
         elementwise_work(h, sc, sh))
    del h, got
    check_stdit3_linear_kernels(dev, rec, gen, S, rows=rows, T=T, L=LATTE_CAP)


def make_latte_model(dev):
    from magcache_tpu_torch.models.latte import LATTE_1, LatteModel

    cfg = dataclasses.replace(LATTE_1, dtype="bfloat16")
    t0 = time.time()
    model = LatteModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  Latte-1 bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def phase_latte_forward(dev, model):
    """One full-shape forward per route, twice each; returns the vpu
    route's launches (its only run in this script)."""
    from magcache_tpu_torch.models.latte import make_latte_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    log("phase 20: full-shape forwards of Latte-1 512x512 x 16, 2 rows, on the "
        "packed, grouped and vpu routes")
    gen = torch.Generator(device=dev).manual_seed(20)
    T, gh, gw = LATTE_GRID
    x = torch.randn((2, T, 2 * gh, 2 * gw, 4), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"y": MockTextEncoder(LATTE_CAP, 4096, scale=0.5)(["a boat", ""], device=dev)}
    outs = {}
    for route in ("packed", "grouped", "vpu"):
        core = make_latte_core(model, LATTE_GRID, LATTE_CAP, route=route)
        reset_counts()
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.time()
            hidden, c = core.prepare(x, t, cond)
            out = core.head(core.trunk(hidden, c), c)
            torch.cuda.synchronize()
            log(f"  {route} forward ({run} call): {time.time() - t0:.3f} s, "
                f"{hidden.shape[1]} tokens x {hidden.shape[0]} rows")
        counts = read_counts()
        if tuple(out.shape) != (2, T, 2 * gh, 2 * gw, 4) or not bool(torch.isfinite(out).all()):
            fail(f"{route} forward output {tuple(out.shape)} is not finite or misshapen")
        per_run = {k: n // 2 for k, n in counts.items()}
        log(f"  {route}: output finite, std {float(out.float().std()):.4f}; launches "
            f"per forward {per_run}")
        if per_run != LATTE_TRUNK_LAUNCHES[route]:
            fail(f"{route}: launches per forward {per_run} != {LATTE_TRUNK_LAUNCHES[route]}")
        check_routes(f"{route} forward", 2, LATTE_ROUTES[route], LATTE_TINY_ROUTES[route])
        outs[route] = out.float()
    for route in ("grouped", "vpu"):
        rel = float((outs[route] - outs["packed"]).norm() / outs["packed"].norm())
        log(f"  rel L2 of the {route} route's output against the packed route's: {rel:.3e}")
    return counts


def phase_latte_requests(dev, model):
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    log(f"phase 21: requests through LattePipeline.generate, 512x512 x 16 frames, "
        f"{LATTE_STEPS} DDIM steps, guidance 7.5: calibration, then MagCache with the "
        f"recorded ratios (E 0.12 K 3 R 0.2) on the packed and the grouped route")
    base = dict(num_sampling_steps=LATTE_STEPS, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    reset_counts()
    cal = LattePipeline(LattePipelineConfig(magcache_calibration=True, **base), dev,
                        model=model)
    out = cal.generate(prompt, seed=3)
    full_latents = out.latents.float().cpu()
    ratios = tuple(out.calibration["norm_ratio"])
    packed = dict(read_counts())
    if len(ratios) != LATTE_STEPS - 1 or not np.all(np.isfinite(ratios)):
        fail(f"calibration recorded {len(ratios)} ratios, or non-finite ones")
    for k, n in packed.items():
        if n != LATTE_TRUNK_LAUNCHES["packed"][k] * LATTE_STEPS:
            fail(f"calibration: {k} launched {n} times, expected "
                 f"{LATTE_TRUNK_LAUNCHES['packed'][k]} x {LATTE_STEPS}")
    secs = {"calibration (full compute)": out.timings["total_s"]}
    log(f"  calibration: {secs['calibration (full compute)']:.3f} s, norm_ratio "
        f"{np.round(ratios[:4], 4).tolist()} ... {np.round(ratios[-3:], 4).tolist()}")
    lats, mask = {}, None
    for route in ("packed", "grouped"):
        pipe = LattePipeline(LattePipelineConfig(use_magcache=True, magcache_ratios=ratios,
                                                 route=route, **base), dev, model=model)
        want = pipe.skip_mask_for()
        mask = want if mask is None else mask
        before = read_counts()
        out = pipe.generate(prompt, seed=3, skip_override=None if route == "packed" else mask)
        launched = count_launches(before)
        lat = out.latents
        if tuple(lat.shape) != (1, 16, 64, 64, 4) or not bool(torch.isfinite(lat).all()):
            fail(f"{route}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, mask) or not np.array_equal(want, mask):
            fail(f"{route}: realized skips differ from skip_mask_for")
        runs = int((~out.skips.all(1)).sum())
        for k, got in launched.items():
            if got != LATTE_TRUNK_LAUNCHES[route][k] * runs:
                fail(f"{route}: {k} launched {got} times, expected "
                     f"{LATTE_TRUNK_LAUNCHES[route][k]} x {runs} trunk runs")
            if route == "packed":
                packed[k] += got
        grouped = launched
        secs[route] = out.timings["total_s"]
        lats[route] = lat
        log(f"  MagCache, {route} route: {secs[route]:.3f} s/video, {runs} of "
            f"{LATTE_STEPS} forwards computed, skipped steps "
            f"{np.flatnonzero(out.skips.any(1)).tolist()}, latents std {float(lat.std()):.4f}")
    rel = float((lats["grouped"] - lats["packed"]).norm() / lats["packed"].norm())
    ceiling = LATTE_STEPS / (LATTE_STEPS - int(mask.sum()))
    log(f"  rel L2 of the grouped route's latents against the packed route's: {rel:.3e}")
    log(f"  speedup {secs['calibration (full compute)'] / secs['packed']:.3f}x (packed "
        f"MagCache against the full-compute calibration request) against a schedule "
        f"ceiling of {ceiling:.3f}x")
    log(f"  launches in phase 21: packed {packed}; grouped {grouped}")
    return packed, grouped, full_latents


def _numpy_latte_tree(cfg, rng):
    """A random Latte parameter tree in the JAX package's layout
    (depth-stacked blocks, ``w: [d_in, d_out]``)."""
    d, L, p2 = cfg.hidden, cfg.depth, cfg.patch * cfg.patch

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def group(cross):
        g = {n: lin(d, w * d, L) for n, w in (("qkv", 3), ("proj", 1),
                                              ("ff1", cfg.mlp_ratio))}
        g["ff2"] = lin(cfg.mlp_ratio * d, d, L)
        g["scale_shift"] = rng.standard_normal((L, 6, d)) / math.sqrt(d)
        if cross:
            g.update(cross_q=lin(d, d, L), cross_kv=lin(d, 2 * d, L), cross_o=lin(d, d, L))
        return g

    return {"patch_embed": lin(cfg.in_channels * p2, d),
            "caption": {"in": lin(cfg.caption_dim, d), "out": lin(d, d)},
            "time": {"in": lin(cfg.time_embed_dim, d), "out": lin(d, d)},
            "adaln_single": lin(d, 6 * d), "spatial": group(True), "temporal": group(False),
            "final_mod": rng.standard_normal((2, d)) / math.sqrt(d),
            "final_out": lin(d, cfg.c_out * p2)}


def phase_latte_card_vs_cpu(dev):
    from magcache_tpu_torch.models.convert import latte_params_from_numpy
    from magcache_tpu_torch.models.latte import LatteConfig, LatteModel
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    log("phase 22: the Latte slice on the card (kernels, bf16) vs the CPU (plain, "
        "f32): hidden 144, 2 heads of 72, 2 block pairs, 16 frames at 256x256, "
        "packed and grouped routes")
    cfg = LatteConfig(hidden=144, heads=2, depth=2, caption_dim=64, time_embed_dim=64,
                      out_channels=8)
    tree = _numpy_latte_tree(cfg, np.random.default_rng(22))
    # 256x256 pixels -> 16 frames of 16 x 16 = 256 tokens (> 128: K1 runs the
    # unpacked route's spatial attention)
    base = dict(num_frames=16, height=256, width=256, num_sampling_steps=8, caption_len=20)
    mask = np.array([0, 0, 1, 0, 1, 1, 0, 0], bool)[:, None]
    runs = int((~mask).sum())
    for route in ("packed", "grouped"):
        outs, fwd = {}, {}
        reset_counts()
        for name, device, dtype in (("card", dev, "bfloat16"),
                                    ("cpu", torch.device("cpu"), "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = LatteModel(c, device)
            model.load_state_dict(latte_params_from_numpy(tree, c, device))
            pipe = LattePipeline(LattePipelineConfig(dtype=dtype, route=route, **base),
                                 device, model=model)
            out = pipe.generate("a red boat", seed=4, skip_override=mask)
            outs[name] = out.latents.float().cpu()
            if name == "card":
                launched = read_counts()
            # one forward on the same seeded input, timestep and captions
            core = pipe.core
            x_fwd = np.random.default_rng(23).standard_normal(
                (2,) + pipe.latent_shape).astype(np.float32)
            hidden, ctx = core.prepare(
                torch.from_numpy(x_fwd).to(device),
                torch.full((2,), float(pipe.schedule.timesteps[0]), device=device),
                {"y": pipe.text_encoder(["a red boat", ""], device=device)})
            fwd[name] = core.head(core.trunk(hidden, ctx), ctx).float().cpu()
        got, want = outs["card"], outs["cpu"]
        rel = float((got - want).norm() / want.norm())
        # bf16 activations through 2 block pairs and 5 computed steps vs f32:
        # rounding of ~2^-8 per op, accumulated -> a few percent at most
        log(f"  {route}: latents {tuple(got.shape)}, {runs} trunk runs, rel L2 "
            f"{rel:.3e} (tol 5e-2), max_abs_err {float((got - want).abs().max()):.3e}; "
            f"card launches {launched}")
        want_launches = {k: n // 14 * runs for k, n in LATTE_TRUNK_LAUNCHES[route].items()}
        if not bool(torch.isfinite(got).all()) or rel > 5e-2:
            fail(f"{route}: card and CPU slices disagree")
        if launched != want_launches:
            fail(f"{route}: card launches {launched} != {want_launches}")
        # where the gap comes from: one forward (prepare, trunk, head) on the
        # same input, before any DDIM step amplifies it; a measurement only
        log(f"  {route}: one forward on the same input, card vs CPU: rel L2 "
            f"{rel_l2(fwd['card'], fwd['cpu']):.3e} (after the {len(mask)} DDIM steps "
            f"above: {rel:.3e})")


# ------------------------------------------------- Wan, sequence-parallel
def phase_sp_kernels(dev, rec):
    """K1b, K1c and K3p vs their plain versions at the sp = 4 shapes."""
    import torch.nn.functional as F

    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P
    from magcache_tpu_torch.parallel import collectives as C
    from magcache_tpu_torch.parallel.mesh import run_local_ranks

    log(f"phase 23: kernels vs plain at the sp = {SP} shapes of Wan2.1-1.3B "
        f"832x480x81 (bf16)")
    gen = torch.Generator(device=dev).manual_seed(2323)
    B, S, H, D, L = 2, 21 * 30 * 52, 12, 128, 512
    Sr, Hr = S // SP, H // SP

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    def heads_first(*shape):
        # what the sequence-parallel path hands the kernels: the head-major
        # view of a [B, S, H, D] activation, no transpose copy
        return rnd(*shape).transpose(1, 2)

    # K1b: K1's kernel body and K1's tolerance (a bf16 ulp or two of the output)
    q, k, v = heads_first(B, S, Hr, D), heads_first(B, S, Hr, D), heads_first(B, S, Hr, D)
    cq = heads_first(B, Sr, H, D)
    ck, cv = heads_first(B, L, H, D), heads_first(B, L, H, D)
    for label, (qq, kk, vv), fm in (
            (f"Ulysses self 2x{Hr}x{S}x128, fixed_max=16", (q, k, v), 16.0),
            (f"cross 2x{H}x{Sr}x128 x 512 keys, fixed_max=16", (cq, ck, cv), 16.0),
            (f"Ulysses self 2x{Hr}x{S}x128, running max", (q, k, v), None)):
        got = A.flash_attention_bhsd(qq, kk, vv, fixed_max=fm)
        want = A.flash_attention_bhsd_plain(qq, kk, vv, fixed_max=fm)
        if got.stride() != qq.stride():
            fail(f"K1b [{label}]: the output does not keep q's layout")
        err = compare(f"K1b flash_attention_bhsd [{label}]", got, want, atol=2e-3, rtol=2e-2)
        ms = cuda_ms(lambda: A.flash_attention_bhsd(qq, kk, vv, fixed_max=fm), 5)
        pms = cuda_ms(lambda: A.flash_attention_bhsd_plain(qq, kk, vv, fixed_max=fm), 2)
        lms = cuda_ms(lambda: F.scaled_dot_product_attention(qq, kk, vv), 5)
        flops = 4 * B * qq.shape[1] * qq.shape[2] * kk.shape[2] * D
        moved = 2 * nbytes(qq) + nbytes(kk, vv)
        log(f"  K1b [{label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), "
            f"plain {pms:.3f} ms, SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bhsd", err, ms, pms, "loop", label, (flops, moved),
             ("F.scaled_dot_product_attention", lms))
    del q, k, v, cq, ck, cv, got, want

    # K1c: o as K1; m is the max of f32 scores whose products sum in another
    # order (|s| < 16 -> 1e-4 covers it); l sums 8,190 f32 terms -> 1e-4 relative
    q, k, v = heads_first(B, Sr, H, D), heads_first(B, Sr, H, D), heads_first(B, Sr, H, D)
    label = f"ring step 2x{H}x{Sr}x128"
    o, m, l = A.flash_attention_bhsd_aux(q, k, v)
    ow, mw, lw = A.flash_attention_bhsd_aux_plain(q, k, v)
    err = compare(f"K1c flash_attention_bhsd_aux [{label}] o", o, ow, atol=2e-3, rtol=2e-2)
    compare(f"K1c [{label}] m (natural base)", m, mw, atol=1e-4, rtol=0.0)
    compare(f"K1c [{label}] l", l, lw, atol=0.0, rtol=1e-4)
    ms = cuda_ms(lambda: A.flash_attention_bhsd_aux(q, k, v), 5)
    pms = cuda_ms(lambda: A.flash_attention_bhsd_aux_plain(q, k, v), 2)
    lms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 5)
    flops = 4 * B * H * Sr * Sr * D
    moved = 2 * nbytes(q) + nbytes(k, v, m, l)
    log(f"  K1c [{label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), plain "
        f"{pms:.3f} ms, SDPA {lms:.3f} ms (o only: not the same function)")
    keep(rec, "flash_attention_bhsd_aux", err, ms, pms, "loop", label, (flops, moved),
         ("F.scaled_dot_product_attention (no m, l: not the same function)", lms))
    del q, k, v, o, ow, m, mw, l, lw

    # the ring merge of SP key shards (K1c partials, merged in f32, o rounded
    # to bf16 at each of the SP - 1 merges: half an ulp of |o| < 0.25 each)
    # against K1 with the running max over the whole sequence; rel L2 2e-2:
    # K1's own distance from exact plus SP - 1 bf16 roundings of 2^-9 each
    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    want = A.flash_attention_bshd(q, k, v)
    before = read_counts()
    outs = run_local_ranks(SP, lambda plan: C.ring_attention(
        *(C.split_sequence(t, plan) for t in (q, k, v)), plan), device=dev)
    torch.cuda.synchronize()
    steps = count_launches(before)["flash_attention_bhsd_aux"]
    if steps != SP * SP:
        fail(f"ring attention launched K1c {steps} times, expected {SP * SP}")
    compare(f"ring merge of {SP} K1c shards vs K1 running max, 2x{S}x12x128",
            torch.cat(outs, 1), want, atol=2e-3 + (SP - 1) * 2 ** -11, rtol=2e-2,
            rel_tol=2e-2)
    del q, k, v, want, outs

    # K3p: one rounding, at the store, as its plain version; a tie may flip
    # after a differently ordered f32 sum -> one bf16 ulp at |y| < 8
    x = rnd(B, S, H * D, scale=2.0)
    got = P.layer_norm_mod(x, eps=1e-6)
    want = P.layer_norm_mod_plain(x, eps=1e-6)
    err = compare("K3p layer_norm_mod [plain mode]", got, want, atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(x, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, eps=1e-6))
    lms = cuda_ms(lambda: F.layer_norm(x, (H * D,), eps=1e-6))
    log(f"  K3p: kernel {ms:.3f} ms ({2 * nbytes(x) / ms / 1e6:.0f} GB/s), plain "
        f"{pms:.3f} ms, F.layer_norm {lms:.3f} ms")
    keep(rec, "layer_norm_mod_plain", err, ms, pms, "loop", "2x32760x1536 plain",
         elementwise_work(x), ("F.layer_norm (no affine)", lms))


def check_ranks_agree(label: str, outs) -> None:
    """Every rank gathers the whole sequence: the same bits on each."""
    for r, o in enumerate(outs[1:], 1):
        if not torch.equal(o, outs[0]):
            fail(f"{label}: rank {r}'s output differs from rank 0's")


def phase_sp_forward(dev, model, single):
    from magcache_tpu_torch.models.wan import make_wan_core
    from magcache_tpu_torch.parallel.mesh import run_local_ranks

    log(f"phase 24: one full-shape forward of WAN_1_3B 832x480x81 under {SP} local "
        f"ranks (threads on one card: their work is serialised, so this wall time "
        f"is no time of a {SP}-GPU run)")
    x, t, ctx, want = single
    grid = (21, 30, 52)
    for impl in ("ulysses", "ring"):
        def rank(plan):
            core = make_wan_core(model, grid, plan, sp_impl=impl)
            hidden, c = core.prepare(x, t, {"context": ctx})
            if hidden.shape[1] != 21 * 30 * 52 // SP:
                fail(f"rank {plan.rank} holds {hidden.shape[1]} tokens")
            return core.head(core.trunk(hidden, c), c)

        reset_counts()
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.time()
            outs = run_local_ranks(SP, rank, device=dev, timeout=600.0)
            torch.cuda.synchronize()
            log(f"  {impl} forward ({run} call): {time.time() - t0:.3f} s wall, "
                f"{SP} ranks x {21 * 30 * 52 // SP} tokens, serialised on one card")
        per_run = {k: n // 2 for k, n in read_counts().items()}
        expected = wan_launches(sp_trunk_launches(30, SP, impl), 1, SP)
        log(f"  {impl}: launches per forward, all ranks: "
            f"{ {k: n for k, n in per_run.items() if n} }")
        if per_run != expected:
            fail(f"{impl}: launches per forward {per_run} != {expected}")
        out = outs[0]
        if tuple(out.shape) != tuple(want.shape) or not bool(torch.isfinite(out).all()):
            fail(f"{impl}: forward output {tuple(out.shape)} is not finite or misshapen")
        check_ranks_agree(f"{impl} forward", outs)
        # bf16 through 30 blocks: the GEMMs run on 8,190 rows instead of
        # 32,760 (other cuBLAS tiles), the ring shifts by the running max and
        # rounds o at each merge -> within 3e-2 of the single-rank output
        rel = rel_l2(out, want)
        log(f"  {impl}: all ranks return the same output; rel L2 against phase 4's "
            f"single-rank output {rel:.3e} (tol 3e-2)")
        if rel > 3e-2:
            fail(f"{impl}: the sharded forward disagrees with the single-rank one")
        del outs, out


def phase_sp_requests(dev, model, single, sched):
    """``single``: phase 5's single-rank latents by request; ``sched``: its
    E012K2R02 skip schedule."""
    from magcache_tpu_torch.parallel.mesh import run_local_ranks
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 25: requests through WanPipeline.generate under {SP} local ranks, "
        f"832x480x17 (7,800 tokens, {7800 // SP} a rank), {STEPS} UniPC steps, CFG 5.0")
    base = dict(size=(832, 480), frame_num=17, sample_steps=STEPS,
                sample_shift=5.0, guide_scale=5.0, sp=SP)
    requests = [("full compute", "ulysses", False, np.zeros((STEPS, 1), bool)),
                ("MagCache E012K2R02", "ulysses", True, sched),
                ("MagCache E012K2R02", "ring", True, sched)]
    totals = {"ulysses": dict(NO_LAUNCHES), "ring": dict(NO_LAUNCHES)}
    for label, impl, cached, want in requests:
        def rank(plan):
            pipe = WanPipeline(WanPipelineConfig(use_magcache=cached, sp_impl=impl, **base),
                               dev, model=model, plan=plan)
            return pipe.generate(WAN_PROMPT, seed=3)

        reset_counts()
        outs = run_local_ranks(SP, rank, device=dev, timeout=600.0)
        launched = read_counts()
        for r, out in enumerate(outs):
            lat = out.latents
            if tuple(lat.shape) != (1, 5, 60, 104, 16) or not bool(torch.isfinite(lat).all()):
                fail(f"{label}, {impl}, rank {r}: latents not finite or misshapen")
            if not np.array_equal(out.skips, want):
                fail(f"{label}, {impl}, rank {r}: realized skips differ from the schedule")
        check_ranks_agree(f"{label}, {impl}", [o.latents for o in outs])
        runs = int((~want.all(1)).sum())
        expected = wan_launches(sp_trunk_launches(30, SP, impl), runs, SP * STEPS)
        for k, got in launched.items():
            if got != expected[k]:
                fail(f"{label}, {impl}: {k} launched {got} times, expected {expected[k]} "
                     f"({runs} trunk runs on {SP} ranks)")
            totals[impl][k] += got
        # against phase 5's single-rank latents of the same request: the
        # forward's bf16 differences (phase 24) carried through 20 UniPC
        # steps at guidance 5 -> within 1e-1
        rel = rel_l2(outs[0].latents, single[label])
        log(f"  {label}, {impl}: {max(o.timings['total_s'] for o in outs):.3f} s wall "
            f"({SP} ranks serialised on one card), {runs} trunk runs, skip bits equal on "
            f"every rank, latents identical on every rank, rel L2 against the single-rank "
            f"request {rel:.3e} (tol 1e-1)")
        if rel > 1e-1:
            fail(f"{label}, {impl}: latents disagree with the single-rank request")
    log(f"  launches in phase 25: {totals}")
    return totals["ulysses"], totals["ring"]


def phase_sp_card_vs_cpu(dev, cpu_latents):
    from magcache_tpu_torch.parallel.mesh import run_local_ranks

    log("phase 26: the narrow Wan slice on the card (kernels, bf16) under 2 local "
        "ranks vs the CPU (plain, f32) on one rank")
    model = narrow_wan_model(dev, torch.bfloat16)      # one set of weights, both ranks
    runs = int((~NARROW_MASK.all(1)).sum())
    for impl in ("ulysses", "ring"):
        reset_counts()
        outs = run_local_ranks(2, lambda plan: narrow_wan_run(model, plan, impl), device=dev)
        launched = read_counts()
        check_ranks_agree(f"narrow slice, {impl}", outs)
        check_narrow(f"2 ranks, {impl}", outs[0], cpu_latents, launched,
                     wan_launches(sp_trunk_launches(NARROW_LAYERS, 2, impl), runs,
                                  2 * len(NARROW_MASK)))


# ------------------------------------------- Open-Sora 1.2, unpacked routes
def phase_os_unpacked_kernels(dev, rec):
    """K1 at head dim 72 zero-padded to 128 and K4 as STDiT3's unpacked
    routes call them at 480p 9:16 x 51 (bf16)."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import tiny_attention as TA
    from magcache_tpu_torch.ops.norms import rms_norm
    from magcache_tpu_torch.ops.rope import grouped_rope_tables, rope_freqs_1d

    log("phase 27: kernels vs plain at STDiT3-XL/2's unpacked 480p 9:16 x 51 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(2727)
    rows, T, S, H, D, L = 2, 15, 1590, 16, 72, 300
    sdpa = "F.scaled_dot_product_attention"

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K1 as attention() runs it at head dim 72: spatial self-attention over
    # each frame (q/k RMS-normed, fixed max; and the running max as
    # qk_norm=False runs it, at 480p and over the 3,600-token frames of
    # 720p) and cross-attention over the 300 caption keys
    normed = [rms_norm(rnd(rows * T, S, H, D, scale=2.0),
                       1.0 + rnd(D, dtype=torch.float32, scale=0.1), eps=1e-6)
              for _ in range(2)]
    for label, b, sq, skv, fm in (
            (f"fixed max, STDiT3 spatial {rows * T}x{S}x{H}x72 -> 128", rows * T, S, S,
             A.QKNORM_FIXED_MAX),
            (f"running max, STDiT3 spatial {rows * T}x{S}x{H}x72 -> 128", rows * T, S, S,
             None),
            (f"running max, STDiT3 720p spatial {rows * T}x3600x{H}x72 -> 128", rows * T,
             3600, 3600, None),
            (f"running max, STDiT3 cross {rows}x{T * S} x {L} keys, 72 -> 128", rows,
             T * S, L, None)):
        q = normed[0] if sq == S else rnd(b, sq, H, D)
        k = normed[1] if skv == S else rnd(b, skv, H, D)
        v = rnd(b, skv, H, D)
        k1_check(rec, f"K1 [{label}]", label, q, k, v, fm)
        del q, k, v
    del normed

    # K5r's "stream" route with RoPE and no norm, as the packed temporal
    # blocks run it without qk-norm (3,180 groups of 15 frames)
    qkv = rnd(1, rows * S * T, 3 * H * D)
    tabs = tuple(torch.from_numpy(a).to(dev) for a in grouped_rope_tables(T, T, D))
    kw = dict(group=T, scale=D ** -0.5, rope_tables=tabs)
    route = A.grouped_kernel(T, None, tabs, None)
    if route != "stream":
        fail(f"K5r temporal with RoPE and no norm takes route {route!r}, not 'stream'")
    got = A.grouped_attention_fused_qkv(qkv, H, **kw)
    want = A.grouped_attention_fused_qkv_plain(qkv, H, **kw)
    record(rec, "grouped_attention_fused_qkv_rowmax", f"STDiT3 480p temporal "
           f"{rows * S * T} rows, group {T}, RoPE, no norm, route {route}", got, want,
           cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **kw)),
           cuda_ms(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **kw), 1),
           4 * rows * S * H * T * T * D, nbytes(qkv, got, *tabs))
    del qkv, got, want

    # K4 as the "grouped" route calls it: q and k normed and rotated by plain
    # ops and rounded (ops.tiny_attention._grouped), then K4 over groups of
    # 15 without gains (the row max): SDPA on the same q^/k^/v computes the
    # same function. The whole tiny_temporal_attention call timed beside it.
    Rs = rows * S
    qkv = rnd(Rs, T, 3 * H * D)
    gains = tuple(1.0 + 0.1 * torch.randn(D, generator=gen, device=dev) for _ in range(2))
    cos, sin = (torch.from_numpy(a).to(dev) for a in rope_freqs_1d(np.arange(T), D))
    q, k, v = A.split_qkv(qkv, H)
    q, k = TA._norm_rope(q, k, *gains, cos, sin, 1e-6)
    flat = [t.reshape(1, Rs * T, H, D) for t in (q.to(v.dtype), k.to(v.dtype), v)]
    kw = dict(group=T, scale=D ** -0.5)
    got = A.grouped_flash_attention_bshd(*flat, **kw)
    want = A.grouped_flash_attention_bshd_plain(*flat, **kw)
    flops, moved = 4 * Rs * H * T * T * D, nbytes(*flat, got)
    lms = sdpa_ms(*(t.reshape(Rs, T, H, D) for t in flat), 20)
    record(rec, "grouped_flash_attention_bshd", f"STDiT3 480p temporal {Rs * T} rows, "
           f"group {T}, q/k pre-normed and rotated (the grouped route's call)", got, want,
           cuda_ms(lambda: A.grouped_flash_attention_bshd(*flat, **kw)),
           cuda_ms(lambda: A.grouped_flash_attention_bshd_plain(*flat, **kw), 1),
           flops, moved, library=(sdpa, lms))
    whole = cuda_ms(lambda: TA.tiny_temporal_attention(qkv, *gains, cos, sin, H,
                                                       mode="grouped"))
    log(f"    the grouped route's tiny_temporal_attention call (plain norm and RoPE, "
        f"then K4): {whole:.3f} ms")
    del qkv, q, k, v, flat, got, want


# 28 (spatial, temporal) block pairs per trunk run on STDiT3's unpacked
# routes: K3 before each attention, K1 spatial (fixed max with qk-norm) and
# two cross, K7 mlp1 twice, and the route's temporal kernel
OS_UNPACKED_LAUNCHES = {
    route: dict(NO_LAUNCHES, layer_norm_mod=56, flash_attention_bshd=84, lnmod_matmul=56,
                **{kernel: 28})
    for route, kernel in (("grouped", "grouped_flash_attention_bshd"),
                          ("vpu", "tiny_temporal_attention"))}
OS_UNPACKED_ROUTES = {"grouped": (dict(NO_ROUTES, stream=28), NO_TINY_ROUTES),
                      "vpu": (NO_ROUTES, dict(NO_TINY_ROUTES, stream=28))}
# without qk-norm: the row max everywhere, no fixed-max launch; packed K5r
# (spatial "tma", temporal "stream"); at 720p K1 (attention()'s pad) in the
# spatial blocks; the grouped route the same at both sizes
OS_NOQK_LAUNCHES = {
    "packed": dict(OS_TRUNK_LAUNCHES, grouped_attention_fused_qkv=0,
                   grouped_attention_fused_qkv_rowmax=56),
    "grouped": OS_UNPACKED_LAUNCHES["grouped"],
    "packed 720p": dict(OS_TRUNK_LAUNCHES, grouped_attention_fused_qkv=0,
                        grouped_attention_fused_qkv_rowmax=28, flash_attention_bshd=28),
    "grouped 720p": OS_UNPACKED_LAUNCHES["grouped"]}
OS_NOQK_ROUTES = {"packed": dict(NO_ROUTES, tma=28, stream=28),
                  "grouped": dict(NO_ROUTES, stream=28),
                  "packed 720p": dict(NO_ROUTES, stream=28),
                  "grouped 720p": dict(NO_ROUTES, stream=28)}


def phase_os_unpacked_forward(dev, model):
    """Packed, grouped and vpu forwards at 480p on the same weights and
    inputs; returns the grouped and vpu paths' launches."""
    log("phase 28: full-shape forwards of STDiT3-XL/2 480p 9:16 x 51, 2 rows, on the "
        "packed, grouped and vpu routes")
    grid, pixels = (15, 30, 53), (480, 854)
    inputs = os_inputs(dev, grid, 8)
    outs, paths = {}, {}
    for route in ("packed", "grouped", "vpu"):
        reset_counts()
        outs[route] = os_forward(model, grid, pixels, route, inputs, route,
                                 runs=1 if route == "packed" else 2)
        if route == "packed":
            continue
        paths[route] = check_forward_counts(
            f"{route} forward", 2, OS_UNPACKED_LAUNCHES[route], *OS_UNPACKED_ROUTES[route],
            fixed=28)
        rel = rel_l2(outs[route], outs["packed"])
        log(f"  rel L2 of the {route} route's output against the packed route's: "
            f"{rel:.3e} (tol 5e-2)")
        if rel > 5e-2:
            fail(f"the {route} route's forward disagrees with the packed route's")
    return paths


def phase_os_unpacked_request(dev, model, launches):
    """One MagCache request on the grouped route; its launches add to the
    grouped path's."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log(f"phase 29: a MagCache request on the grouped route, 480p 9:16 x {OS_FRAMES} "
        f"frames, {OS_STEPS} RFLOW steps")
    pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        resolution="480p", aspect_ratio="9:16", num_frames=OS_FRAMES,
        num_sampling_steps=OS_STEPS, cfg_scale=7.0, dtype="bfloat16", use_magcache=True,
        route="grouped"), dev, model=model)
    sched = compute_skip_schedule(pipe._cache_cfg()).reshape(OS_STEPS, 1)
    reset_counts()
    out = pipe.generate("A red sailboat glides across a calm bay at dawn.", seed=3)
    lat = out.latents
    if tuple(lat.shape) != (1, 15, 60, 106, 4) or not bool(torch.isfinite(lat).all()):
        fail(f"grouped request: latents {tuple(lat.shape)} not finite or misshapen")
    if not np.array_equal(out.skips, sched):
        fail("grouped request: realized skips differ from the schedule")
    runs = int((~out.skips.all(1)).sum())
    counts = check_forward_counts("grouped request", runs, OS_UNPACKED_LAUNCHES["grouped"],
                                  *OS_UNPACKED_ROUTES["grouped"], fixed=28)
    log(f"  {out.timings['total_s']:.3f} s/video, {runs} of {OS_STEPS} forwards "
        f"computed, skipped steps {np.flatnonzero(out.skips.any(1)).tolist()}, latents "
        f"std {float(lat.std()):.4f}")
    return {k: n + counts[k] for k, n in launches.items()}


def phase_os_noqknorm(dev):
    """STDiT3 with ``qk_norm=False``: forwards on packed and grouped at
    480p and at 720p (frames above 2,048 tokens), each grouped output held
    to the packed one; the row max everywhere. Returns the path's
    launches."""
    from magcache_tpu_torch.models.stdit3 import STDIT3_XL_2, STDiT3Model

    log("phase 30: STDiT3-XL/2 without qk-norm: 480p and 720p 9:16 x 51 on packed and "
        "grouped")
    cfg = dataclasses.replace(STDIT3_XL_2, qk_norm=False, dtype="bfloat16")
    model = STDiT3Model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    total = dict(NO_LAUNCHES)
    outs = {}
    for label, grid, pixels in (("packed", (15, 30, 53), (480, 854)),
                                ("grouped", (15, 30, 53), (480, 854)),
                                ("packed 720p", (15, 45, 80), (720, 1280)),
                                ("grouped 720p", (15, 45, 80), (720, 1280))):
        reset_counts()
        outs[label] = os_forward(model, grid, pixels, label.split()[0],
                                 os_inputs(dev, grid, 30), f"{label} (no qk-norm)")
        counts = check_forward_counts(f"{label} (no qk-norm)", 1, OS_NOQK_LAUNCHES[label],
                                      OS_NOQK_ROUTES[label], fixed=0)
        total = {k: n + counts[k] for k, n in total.items()}
    for size in ("", " 720p"):
        rel = rel_l2(outs["grouped" + size], outs["packed" + size])
        log(f"  rel L2 of the grouped route's{size} output against the packed route's: "
            f"{rel:.3e} (tol 5e-2)")
        if rel > 5e-2:
            fail(f"without qk-norm the grouped and packed routes disagree{size}")
    del model
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------ Wan2.1: UMT5 and the VAE
def phase_umt5(dev):
    """UMT5-XXL at full width in its config's dtype: 2 prompts x 512 tokens
    through the hash tokenizer; then a narrow encoder on the card against
    the CPU. Returns the full-width encoder (the request of phase 33 uses
    it)."""
    from magcache_tpu_torch.models.text import FallbackHashTokenizer
    from magcache_tpu_torch.models.umt5 import UMT5_XXL, UMT5Config, UMT5Encoder, UMT5Model
    from magcache_tpu_torch.pipelines.wan import DEFAULT_NEGATIVE

    log(f"phase 31: UMT5-XXL encode, 2 prompts x 512 tokens, {UMT5_XXL.dtype}")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    tok = FallbackHashTokenizer(UMT5_XXL.vocab_size)
    enc = UMT5Encoder(UMT5_XXL, seq_len=512, tokenizer=tok, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(31))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in enc.model.parameters())
    log(f"  random init: {time.time() - t0:.1f} s, {n / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB ({UMT5_XXL.dtype})")
    prompts = [WAN_PROMPT, DEFAULT_NEGATIVE]
    for run in ("first", "second"):
        torch.cuda.synchronize()
        t0 = time.time()
        out = enc(prompts)
        torch.cuda.synchronize()
        log(f"  encode ({run} call): {time.time() - t0:.3f} s")
    mask = torch.from_numpy(tok(prompts, max_length=512)["attention_mask"]).to(dev)
    if (tuple(out.shape) != (2, 512, 4096) or not bool(torch.isfinite(out).all())
            or bool(out[mask == 0].any())):
        fail(f"UMT5 output {tuple(out.shape)} not finite, misshapen or nonzero past the "
             f"prompt")
    log(f"  output {tuple(out.shape)} {out.dtype}, {int(mask.sum())} prompt tokens, std "
        f"{float(out[mask == 1].float().std()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} GB")

    cfg = UMT5Config.tiny(d_model=256, d_ff=512, heads=4, d_kv=64, vocab_size=1000)
    ids = np.random.default_rng(31).integers(2, 1000, (2, 64))
    attn = np.ones((2, 64), np.int64)
    attn[1, 40:] = 0
    card = UMT5Encoder(cfg, device=dev)
    cpu_model = UMT5Model(cfg, "cpu")
    cpu_model.load_state_dict(card.model.state_dict())
    cpu = UMT5Encoder(cfg, model=cpu_model)
    got = card.encode_ids(ids, attn).cpu()
    want = cpu.encode_ids(ids, attn)
    # f32 without TF32 on both: summation order only
    err = float((got - want).abs().max() / want.abs().max())
    log(f"  narrow encoder (d 256, 3 layers) card vs CPU, f32: max |diff| / max |CPU| "
        f"{err:.3e} (tol 1e-4), rel L2 {rel_l2(got, want):.3e}")
    if err > 1e-4:
        fail("UMT5 on the card disagrees with the CPU")
    return enc


def phase_vae_decode(dev):
    """The Wan2.1 VAE decoding 832x480x81 streamed, in f32 and bf16; then a
    narrow clip card vs CPU and streamed vs whole. Returns the f32 VAE."""
    from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE

    log("phase 32: Wan2.1 VAE decode, latents [1, 21, 60, 104, 16] -> pixels "
        "[1, 81, 480, 832, 3], one latent frame a call")
    z = torch.randn((1, 21, 60, 104, 16), generator=torch.Generator(device=dev).manual_seed(32),
                    device=dev)
    vaes, videos = {}, {}
    for dtype in ("float32", "bfloat16"):
        vae = WanVAE(dataclasses.replace(WAN21_VAE, dtype=dtype), dev)
        vaes[dtype] = vae.init(torch.Generator(device=dev).manual_seed(0)).requires_grad_(False)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for run in ("first", "second"):
            torch.cuda.synchronize()
            t0 = time.time()
            video = vaes[dtype].decode(z)
            torch.cuda.synchronize()
            log(f"  {dtype} decode ({run} call): {time.time() - t0:.3f} s")
        if tuple(video.shape) != (1, 81, 480, 832, 3) or not bool(torch.isfinite(video).all()):
            fail(f"{dtype} decode: pixels {tuple(video.shape)} not finite or misshapen")
        log(f"  {dtype}: pixels {tuple(video.shape)} finite, std {float(video.std()):.4f}; "
            f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
            f"({(torch.cuda.max_memory_allocated(dev) - base) / 1e9:.2f} GB above the "
            f"weights, z and the pixels held)")
        videos[dtype] = video
    f32, b16 = videos["float32"], videos["bfloat16"]
    rel_max = float((b16 - f32).abs().max() / f32.abs().max())
    log(f"  bf16 vs f32: max |diff| / max |f32| {rel_max:.3e} (tol 5e-2), rel L2 "
        f"{rel_l2(b16, f32):.3e}")
    if rel_max > 5e-2:
        fail("the bf16 decode strays from the f32 decode")
    del videos, video, f32, b16, vaes["bfloat16"]
    torch.cuda.empty_cache()

    # narrow clip at full width: [1, 3, 4, 6, 16] -> [1, 9, 32, 48, 3]
    vae = vaes["float32"]
    zs = z[:, :3, :4, :6].contiguous()
    card = vae.decode(zs).cpu()
    whole = vae.decode(zs, latent_chunk=None).cpu()
    cpu = WanVAE(vae.cfg, "cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    want = cpu.decode(zs.cpu())
    for label, got, ref in (("card vs CPU, streamed", card, want),
                            ("streamed vs whole, card", card, whole)):
        err = float((got - ref).abs().max() / ref.abs().max())
        # f32 convs without TF32 on both sides: summation order only
        log(f"  narrow clip {tuple(card.shape)} {label}: max |diff| / max |ref| {err:.3e} "
            f"(tol 1e-4), rel L2 {rel_l2(got, ref):.3e}")
        if err > 1e-4:
            fail(f"VAE narrow clip: {label} disagree")
    return vae


def phase_wan_video(dev, text_encoder, vae):
    """One Wan request that ends in pixels: UMT5-XXL, the DiT, the VAE.
    Returns its launches."""
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 33: a Wan request ending in pixels, 832x480x17, {STEPS} UniPC steps, "
        f"UMT5-XXL text, f32 VAE")
    model = make_model(dev)
    pipe = WanPipeline(WanPipelineConfig(size=(832, 480), frame_num=17, sample_steps=STEPS,
                                         sample_shift=5.0, guide_scale=5.0),
                       dev, model=model, text_encoder=text_encoder, vae=vae)
    reset_counts()
    out = pipe.generate(WAN_PROMPT, seed=3)
    counts = read_counts()
    video = out.video
    if (video is None or tuple(video.shape) != (1, 17, 480, 832, 3)
            or not bool(torch.isfinite(video).all())):
        fail(f"Wan request: video {None if video is None else tuple(video.shape)} "
             f"missing, misshapen or not finite")
    expected = wan_launches(TRUNK_LAUNCHES, STEPS, STEPS)
    if counts != expected:
        fail(f"Wan request: launches {counts} != {expected}")
    log(f"  {out.timings['total_s']:.3f} s/video (VAE decode {out.timings['decode_s']:.3f}"
        f" s), video {tuple(video.shape)} finite, std {float(video.std()):.4f}; launches "
        f"{counts}")
    del model, pipe
    return counts


# ------------------------------------------- Wan's other solvers and policies
ROLLING_STEPS = 50    # the published rolling table's length: 100 forwards


def wan_request(pipe, label, want, total, steps=STEPS):
    """One Wan request at 832x480x17: finite latents, the realized skip
    bits equal to ``want`` (None: any), and the launches equal to trunk runs
    x ``TRUNK_LAUNCHES`` plus K3p once a step; a step where one lane skips
    runs the half-batch trunk, one run of each kernel. Adds the launches to
    ``total``; returns the output."""
    before = read_counts()
    out = pipe.generate(WAN_PROMPT, seed=3)
    launched = count_launches(before)
    lat = out.latents
    if tuple(lat.shape) != (1, 5, 60, 104, 16) or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
    bits = out.skips if out.skips is not None else np.zeros((steps, 1), bool)
    if want is not None and not np.array_equal(bits, want):
        fail(f"{label}: realized skips differ from the schedule")
    runs = int((~bits.all(1)).sum())
    expected = wan_launches(TRUNK_LAUNCHES, runs, steps)
    if launched != expected:
        fail(f"{label}: launches {launched} != {expected} ({runs} trunk runs)")
    for k, n in launched.items():
        total[k] += n
    log(f"  {label}: {out.timings['total_s']:.3f} s/video, {runs} trunk runs of {steps} "
        f"steps ({int((bits.sum(1) == 1).sum())} half-batch), skips per lane "
        f"{bits.sum(0).tolist()}, latents std {float(lat.std()):.4f}")
    return out


def phase_wan_solvers(dev, model, unipc_full):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.core.rolling import compute_rolling_schedule, load_eval_ratios
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 34: Wan's dpm++ and Euler solvers and the rolling policy through "
        f"WanPipeline.generate, 832x480x17, {STEPS} steps (rolling: {ROLLING_STEPS}), CFG 5.0")

    def pipe(**kw):
        base = dict(size=(832, 480), frame_num=17, sample_steps=STEPS, sample_shift=5.0,
                    guide_scale=5.0)
        return WanPipeline(WanPipelineConfig(**dict(base, **kw)), dev, model=model)

    reset_counts()
    total = dict(NO_LAUNCHES)
    none = np.zeros((STEPS, 1), bool)
    lats = {}
    for solver in ("dpm++", "euler"):
        out = wan_request(pipe(sample_solver=solver), f"{solver}, full compute", none, total)
        lats[solver] = out.latents.float().cpu()
    cached = pipe(sample_solver="dpm++", use_magcache=True)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(STEPS, 2)
    wan_request(cached, "dpm++, MagCache E012K2R02", sched, total)
    cal = wan_request(pipe(sample_solver="dpm++", magcache_calibration=True),
                      "dpm++, calibration", None, total)
    ratios = tuple(cal.calibration["norm_ratio"])
    if len(ratios) != 2 * (STEPS - 1) or not np.all(np.isfinite(ratios)):
        fail(f"dpm++ calibration recorded {len(ratios)} ratios, or non-finite ones")
    installed = pipe(sample_solver="dpm++", use_magcache=True, mag_ratios_override=ratios)
    if tuple(installed._cache_cfg().mag_ratios[2:]) != ratios:
        fail("the recorded ratios were not installed")
    wan_request(installed, "dpm++, MagCache with the recorded ratios",
                installed.skip_mask_for(), total)
    rolling = compute_rolling_schedule(2 * ROLLING_STEPS, load_eval_ratios(), 0.12, 2)
    if not rolling.any():
        fail("the rolling schedule at 0.12 / K 2 elides no forward")
    wan_request(pipe(sample_steps=ROLLING_STEPS, use_magcache=True, cache_policy="rolling",
                     magcache_thresh=0.12, magcache_K=2),
                f"unipc, rolling 0.12 / K 2 ({int(rolling.sum())} of {2 * ROLLING_STEPS} "
                f"forwards elided)", rolling.reshape(ROLLING_STEPS, 2), total,
                steps=ROLLING_STEPS)
    for solver, lat in lats.items():
        log(f"  rel L2 of {solver}'s full-compute latents against unipc's (phase 5): "
            f"{rel_l2(lat, unipc_full):.3e}")
    log(f"  launches in phase 34: {total}")
    return total


def phase_wan_teacache(dev, model):
    """Returns the phase's launches."""
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 35: Wan TeaCache through WanPipeline.generate, 832x480x17, {STEPS} "
        f"UniPC steps, threshold 0.2, use_ret_steps off and on")
    reset_counts()
    total = dict(NO_LAUNCHES)
    for ret in (False, True):
        pipe = WanPipeline(WanPipelineConfig(
            size=(832, 480), frame_num=17, sample_steps=STEPS, sample_shift=5.0,
            guide_scale=5.0, enable_teacache=True, teacache_thresh=0.2,
            use_ret_steps=ret), dev, model=model)
        forced = pipe._teacache_lanes().forced_mask(STEPS)
        out = wan_request(pipe, f"TeaCache, use_ret_steps={ret}", None, total)
        if (out.skips & forced).any():
            fail(f"use_ret_steps={ret}: a forward of the forced window skipped")
        log(f"    forced window {int(forced.sum())} lane-forwards, all computed; skipped "
            f"steps by lane {[np.flatnonzero(out.skips[:, l]).tolist() for l in (0, 1)]}")
    log(f"  launches in phase 35: {total}")
    return total


# ------------------------------------------------------------ PAB, STDiT3
def pab_site_spy(module, per_block: int):
    """Counts ``module._pab_site`` calls as ``{(position in the block pair,
    kind): [computed, reused, saved]}`` while installed; ``per_block`` is
    the calls a block pair makes. Returns ``(counts, uninstall)``."""
    real = module._pab_site
    counts, seen = {}, [0]

    def spy(slots, reuse, kind, compute, save=True):
        key = (seen[0] % per_block, kind)
        seen[0] += 1
        c = counts.setdefault(key, [0, 0, 0])
        c[1 if reuse[kind] else 0] += 1
        c[2] += int(not reuse[kind] and save and slots.get(kind) is not None)
        return real(slots, reuse, kind, compute, save)

    module._pab_site = spy
    return counts, lambda: setattr(module, "_pab_site", real)


def os_pab_launches(masks: dict, runs: np.ndarray, depth: int = 28):
    """Launches and K5 routes of STDiT3's PAB trunk runs at the steps
    ``runs``: spatial K7 + K5 (prepass), temporal K3 + K5 (stream), K6
    without the residual twice a pair, K7 (mlp1) twice a pair, no K8."""
    want, routes = dict(NO_LAUNCHES), dict(NO_ROUTES)
    for i in np.flatnonzero(runs):
        sp, tp, cr, ml = (not masks[k][i] for k in ("spatial", "temporal", "cross", "mlp"))
        want["lnmod_matmul"] += depth * (sp + 2 * ml)
        want["grouped_attention_fused_qkv"] += depth * (sp + tp)
        want["layer_norm_mod"] += depth * tp
        want["fused_cross_attention_bias"] += 2 * depth * cr
        routes["prepass"] += depth * sp
        routes["stream"] += depth * tp
    return want, routes


def check_launch_routes(label: str, launched: dict, want: dict, routes: dict) -> None:
    from magcache_tpu_torch.ops import attention as A

    got = dict(A._grouped_launch.routes)
    if launched != want or got != routes:
        fail(f"{label}: launches {launched} != {want}, or routes {got} != {routes}")


def pab_trunk_ms(label: str, pipe, plain_core, signature: np.ndarray) -> None:
    """Logs one PAB trunk run's device time for each reuse signature
    (``signature``: a ``bool[steps, sites]`` row per step; its first step of
    each distinct row is timed, -1 is full compute) beside the plain
    packed trunk's, on a seeded input at the schedule's first timestep. The
    trunk state is freshly zeroed (a replayed site reads zeros: the time is
    the same). Two calls each, the second timed between CUDA events."""
    core = pipe.core
    dev = pipe.device
    gen = torch.Generator(device=dev).manual_seed(99)
    x = torch.randn((2,) + pipe.latent_shape, generator=gen, device=dev)
    t = torch.full((2,), float(pipe.schedule.timesteps[0]), device=dev)
    hidden, ctx = core.prepare(x, t, {"y": pipe.text_encoder(["a boat", ""], device=dev)})
    state = core.init_state(hidden, ctx)

    def ms(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    rows, first = np.unique(signature, axis=0, return_index=True)
    parts = [f"plain packed trunk {ms(lambda: plain_core.trunk(hidden, ctx)):.1f} ms",
             f"PAB full compute {ms(lambda: core.trunk(hidden, ctx, state, -1)):.1f} ms"]
    for row, i in zip(rows, first):
        n = int((signature == row).all(1).sum())
        parts.append(f"reuse {row.astype(int).tolist()} ({n} steps) "
                     f"{ms(lambda: core.trunk(hidden, ctx, state, int(i))):.1f} ms")
    log(f"  {label} trunk by reuse signature: " + "; ".join(parts))
    del state


def phase_os_pab(dev, rec, model, full_latents):
    """Returns the launches of the PAB requests and of the rolling one."""
    from magcache_tpu_torch.core.pab import OPEN_SORA_PAB, broadcast_masks
    from magcache_tpu_torch.core.sampler import lane_skip_masks
    from magcache_tpu_torch.models import stdit3 as S
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)

    log(f"phase 36: Open-Sora PAB and the rolling policy, 480p 9:16 x {OS_FRAMES}, "
        f"{OS_STEPS} RFLOW steps, packed route; K6 without the residual first")
    gen = torch.Generator(device=dev).manual_seed(36)
    rows, N, d, H, L = 2, 15 * 1590, 1152, 16, 300

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    h, k, v = rnd(rows, N, d), rnd(rows, L, d), rnd(rows, L, d)
    wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
    bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
    kw = dict(scale=(d // H) ** -0.5, true_d=d // H, residual=False)
    got = A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, **kw)
    want = A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H, **kw)
    record(rec, "fused_cross_attention_bias", f"{rows}x{N} x {L} keys, no residual",
           got, want,
           cuda_ms(lambda: A.fused_cross_attention(h, wq, bq, k, v, wo, bo, H, **kw)),
           cuda_ms(lambda: A.fused_cross_attention_plain(h, wq, bq, k, v, wo, bo, H, **kw), 2),
           4 * rows * N * d * d + 4 * rows * N * L * d, nbytes(h, wq, bq, k, v, wo, bo, got))
    del h, k, v, got, want
    torch.cuda.empty_cache()

    base = dict(resolution="480p", aspect_ratio="9:16", num_frames=OS_FRAMES,
                num_sampling_steps=OS_STEPS, cfg_scale=7.0, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    totals = {"pab": dict(NO_LAUNCHES), "rolling": dict(NO_LAUNCHES)}
    for label, kind, kw in (("PAB (OPEN_SORA_PAB)", "pab", dict(enable_pab=True)),
                            ("PAB + MagCache opensora-v1.2", "pab",
                             dict(enable_pab=True, use_magcache=True)),
                            ("rolling 0.12 / K 3, no PAB", "rolling",
                             dict(use_magcache=True, cache_policy="rolling"))):
        pipe = OpenSoraPipeline(OpenSoraPipelineConfig(**base, **kw), dev, model=model)
        sched = lane_skip_masks(pipe._cache_cfg(), OS_STEPS)[0]
        runs = ~sched.all(1)
        reset_counts()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        sites, uninstall = pab_site_spy(S, 6)
        try:
            out = pipe.generate(prompt, seed=3)
        finally:
            uninstall()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        launched = read_counts()
        lat = out.latents
        if tuple(lat.shape) != (1, 15, 60, 106, 4) or not bool(torch.isfinite(lat).all()):
            fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
        if not np.array_equal(out.skips, sched):
            fail(f"{label}: realized skips differ from the schedule")
        if kind == "pab":
            masks = broadcast_masks(OPEN_SORA_PAB, pipe.schedule.timesteps)
            want, routes = os_pab_launches(masks, runs)
            reused = {site: int(masks[m][runs].sum()) for site, m in (
                ("spatial", "spatial"), ("temporal", "temporal"), ("cross", "cross"),
                ("mlp", "mlp"))}
            got_reuse = {"spatial": sites[(0, "attn")][1] // 28,
                         "temporal": sites[(3, "attn")][1] // 28,
                         "cross": sites[(1, "cross")][1] // 28,
                         "mlp": sites[(2, "mlp")][1] // 28}
            log(f"    reuse steps per site {got_reuse} (of {int(runs.sum())} trunk runs; "
                f"the masks: spatial {int(masks['spatial'].sum())}, temporal "
                f"{int(masks['temporal'].sum())}, cross {int(masks['cross'].sum())}, mlp "
                f"{int(masks['mlp'].sum())} of {OS_STEPS}); state slots "
                f"{S.pab_slots(masks, S.PAB_SLOTS)}")
            if got_reuse != reused:
                fail(f"{label}: reuse steps per site {got_reuse} != the masks' {reused}")
            if launched["matmul_gated_residual"] or launched["fused_cross_attention"]:
                fail(f"{label}: a K8 or residual K6 launch in a PAB request")
        else:
            want = {k: n * int(runs.sum()) for k, n in OS_TRUNK_LAUNCHES.items()}
            routes = {k: n * int(runs.sum()) for k, n in OS_ROUTES.items()}
        check_launch_routes(label, launched, want, routes)
        for k, n in launched.items():
            totals[kind][k] += n
        log(f"  {label}: {out.timings['total_s']:.3f} s/video, {int(runs.sum())} of "
            f"{OS_STEPS} trunk runs, peak memory {peak:.2f} GB, rel L2 against full compute "
            f"(phase 9) {rel_l2(lat, full_latents):.3e}, launches {launched}")
    masks = broadcast_masks(OPEN_SORA_PAB, pipe.schedule.timesteps)
    pab_trunk_ms("480p PAB", OpenSoraPipeline(OpenSoraPipelineConfig(**base, enable_pab=True),
                                              dev, model=model),
                 S.make_stdit3_core(model, pipe.grid, pixel_size=(pipe.config.height,
                                                                  pipe.config.width)),
                 np.stack([masks[k] for k in ("spatial", "temporal", "cross", "mlp")], 1))
    log(f"  launches in phase 36: PAB {totals['pab']}; rolling {totals['rolling']}")
    return totals["pab"], totals["rolling"]


# -------------------------------------------------------------- PAB, Latte
def latte_pab_launches(masks: dict, runs: np.ndarray, depth: int = 28):
    """Launches and K5r routes of Latte's PAB trunk runs at the steps
    ``runs``: attention K3 + K5r (spatial "tma", temporal "stream"), cross
    through ``attention()`` (K1), the MLP's K3 in each block that computes
    it."""
    want, routes = dict(NO_LAUNCHES), dict(NO_ROUTES)
    for i in np.flatnonzero(runs):
        sp, tp, cr = (not masks[k][i] for k in ("spatial", "temporal", "cross"))
        mlp = int((~masks["mlp_sp_reuse"][i]).sum() + (~masks["mlp_tp_reuse"][i]).sum())
        want["layer_norm_mod"] += depth * (sp + tp) + mlp
        want["grouped_attention_fused_qkv_rowmax"] += depth * (sp + tp)
        want["flash_attention_bshd"] += depth * cr
        routes["tma"] += depth * sp
        routes["stream"] += depth * tp
    return want, routes


def phase_latte_pab(dev, model, full_latents):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.pab import LATTE_PAB
    from magcache_tpu_torch.models import latte as LM
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig

    log(f"phase 37: Latte PAB (LATTE_PAB) through LattePipeline.generate, 512x512 x 16 "
        f"frames, {LATTE_STEPS} DDIM steps, packed route")
    pipe = LattePipeline(LattePipelineConfig(num_sampling_steps=LATTE_STEPS,
                                             dtype="bfloat16", enable_pab=True),
                         dev, model=model)
    masks = LM.latte_pab_masks(LATTE_PAB, pipe.schedule.timesteps, 28)
    runs = np.ones(LATTE_STEPS, bool)
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    sites, uninstall = pab_site_spy(LM, 5)
    try:
        out = pipe.generate("A red sailboat glides across a calm bay at dawn.", seed=3)
    finally:
        uninstall()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    launched = read_counts()
    lat = out.latents
    if tuple(lat.shape) != (1, 16, 64, 64, 4) or not bool(torch.isfinite(lat).all()):
        fail(f"Latte PAB: latents {tuple(lat.shape)} not finite or misshapen")
    want, routes = latte_pab_launches(masks, runs)
    check_launch_routes("Latte PAB", launched, want, routes)
    got = {"spatial": sites[(0, "attn")][1] // 28, "temporal": sites[(3, "attn")][1] // 28,
           "cross": sites[(1, "cross")][1] // 28,
           "mlp spatial": sites[(2, "mlp")][1], "mlp temporal": sites[(4, "mlp")][1],
           "mlp saves": sites[(2, "mlp")][2] + sites[(4, "mlp")][2]}
    expect = {"spatial": int(masks["spatial"].sum()), "temporal": int(masks["temporal"].sum()),
              "cross": int(masks["cross"].sum()),
              "mlp spatial": int(masks["mlp_sp_reuse"].sum()),
              "mlp temporal": int(masks["mlp_tp_reuse"].sum()),
              "mlp saves": int(masks["mlp_sp_save"].sum() + masks["mlp_tp_save"].sum())}
    blocks = sorted({int(b) for b in np.flatnonzero(masks["mlp_sp_reuse"].any(0))})
    log(f"  reuse steps per site (block-steps for the MLPs) and MLP saves {got}; the "
        f"masks {expect}; MLP reuse on blocks {blocks}")
    if got != expect:
        fail(f"Latte PAB: site counts {got} != the masks' {expect}")
    pab_trunk_ms("Latte PAB", pipe, LM.make_latte_core(model, pipe.grid, LATTE_CAP),
                 np.stack([masks["spatial"], masks["temporal"], masks["cross"],
                           masks["mlp_sp_reuse"].any(1) | masks["mlp_tp_reuse"].any(1)], 1))
    log(f"  Latte PAB: {out.timings['total_s']:.3f} s/video, peak memory {peak:.2f} GB, "
        f"rel L2 against full compute (phase 21's calibration request) "
        f"{rel_l2(lat, full_latents):.3e}, launches {launched}")
    return launched


# ------------------------------------------------- narrow, card against CPU
def phase_narrow_new_paths(dev):
    from magcache_tpu_torch.core.pab import LattePABConfig, OpenSoraPABConfig
    from magcache_tpu_torch.core.presets import make_config
    from magcache_tpu_torch.core.sampler import sample_euler
    from magcache_tpu_torch.models.convert import (latte_params_from_numpy,
                                                   stdit3_params_from_numpy)
    from magcache_tpu_torch.models.latte import LatteConfig, LatteModel, latte_pab_masks
    from magcache_tpu_torch.models.stdit3 import (STDiT3Config, STDiT3Model,
                                                  make_stdit3_core)
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import make_wan_core
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig
    from magcache_tpu_torch.schedulers.dpm_flow import dpmpp_2m_flow_coeffs
    from magcache_tpu_torch.schedulers.flow_match import FlowMatchSchedule
    from magcache_tpu_torch.schedulers.rflow import RFlowSchedule

    log("phase 38: narrow slices of the new paths on the card (kernels, bf16) vs the "
        "CPU (plain, f32): Wan dpm++, STDiT3 PAB, Latte PAB")
    # Wan dpm++: phase 6's slice on the dpm++ update
    sch = FlowMatchSchedule.create(len(NARROW_MASK), shift=5.0)
    outs = {}
    reset_counts()
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu", torch.device("cpu"), torch.float32)):
        model = narrow_wan_model(device, dtype)
        cfg = model.cfg
        ctx = MockTextEncoder(cfg.text_len, cfg.text_dim, scale=0.5)(["a cat", ""])
        lat, skips = sample_euler(
            make_wan_core(model, (2, 8, 12)),
            torch.from_numpy(_narrow_wan_inputs(cfg)[1]).to(device),
            {"context": ctx.to(device)}, timesteps=sch.timesteps, dts=np.diff(sch.sigmas),
            cache_cfg=make_config("wan2.1-t2v-1.3B", len(NARROW_MASK)), guidance_scale=5.0,
            dpm_coeffs=dpmpp_2m_flow_coeffs(sch.sigmas), skip_mask_override=NARROW_MASK,
            return_skips=True)
        if not np.array_equal(skips, NARROW_MASK):
            fail("narrow dpm++: realized skips differ from the override")
        outs[name] = lat.float().cpu()
        if name == "card":
            launched = read_counts()
    per_run = {k: n * NARROW_LAYERS // 30 for k, n in TRUNK_LAUNCHES.items()}
    check_narrow("Wan dpm++", outs["card"], outs["cpu"], launched,
                 wan_launches(per_run, int((~NARROW_MASK.all(1)).sum()), len(NARROW_MASK)))

    # STDiT3 PAB: phase 10's slice with every site's window opened
    cfg = STDiT3Config(hidden=144, heads=2, depth=2, caption_dim=64, freq_dim=64,
                       caption_max_len=20)
    grid = (5, 5, 8)
    rng = np.random.default_rng(12)
    tree = _numpy_stdit3_tree(cfg, rng)
    x0 = rng.standard_normal((1, 5, 10, 16, 4)).astype(np.float32)
    y = MockTextEncoder(20, 64, scale=0.5)(["a red boat", ""])
    mask = np.array([0, 0, 1, 0, 1, 1, 0, 0], bool)[:, None]
    sch = RFlowSchedule.create(len(mask), use_timestep_transform=True, height=80,
                               width=128, num_frames=17)
    pab = OpenSoraPABConfig(spatial_threshold=(0, 1000), temporal_threshold=(0, 1000),
                            cross_threshold=(0, 1000))
    from magcache_tpu_torch.core.pab import broadcast_masks

    masks = broadcast_masks(pab, sch.timesteps)

    def combine(chunks):
        return chunks[1][..., :4] + 7.0 * (chunks[0][..., :4] - chunks[1][..., :4])

    reset_counts()
    for name, device, dtype in (("card", dev, "bfloat16"), ("cpu", torch.device("cpu"), "float32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = STDiT3Model(c, device)
        model.load_state_dict(stdit3_params_from_numpy(tree, c, device))
        core = make_stdit3_core(model, grid, pab=pab, timesteps=sch.timesteps,
                                pixel_size=(80, 128))
        lat = sample_euler(core, torch.from_numpy(x0).to(device),
                           {"y": y.to(device), "fps": torch.full((2,), 24.0, device=device)},
                           timesteps=sch.timesteps, dts=sch.dts(), lanes=2,
                           combine_fn=combine, cache_cfg=make_config("opensora-v1.2", len(mask)),
                           skip_mask_override=mask)
        outs[name] = lat.float().cpu()
        if name == "card":
            launched = read_counts()
    want, _ = os_pab_launches(masks, ~mask[:, 0], depth=2)
    log(f"  STDiT3 PAB reuse steps among the trunk runs: " + ", ".join(
        f"{k} {int(masks[k][~mask[:, 0]].sum())}" for k in ("spatial", "temporal", "cross")))
    check_narrow("STDiT3 PAB", outs["card"], outs["cpu"], launched, want)

    # Latte PAB: phase 22's slice, MLP anchors at the 8-step schedule's 750
    cfg = LatteConfig(hidden=144, heads=2, depth=2, caption_dim=64, time_embed_dim=64,
                      out_channels=8)
    tree = _numpy_latte_tree(cfg, np.random.default_rng(22))
    anchors = ((750, (0, 1), 2),)
    pab = LattePABConfig(mlp_spatial_config=anchors, mlp_temporal_config=anchors)
    base = dict(num_frames=16, height=256, width=256, num_sampling_steps=8, caption_len=20,
                enable_pab=True, pab_config=pab)
    reset_counts()
    for name, device, dtype in (("card", dev, "bfloat16"), ("cpu", torch.device("cpu"), "float32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = LatteModel(c, device)
        model.load_state_dict(latte_params_from_numpy(tree, c, device))
        pipe = LattePipeline(LattePipelineConfig(dtype=dtype, **base), device, model=model)
        outs[name] = pipe.generate("a red boat", seed=4, skip_override=mask).latents.float().cpu()
        if name == "card":
            launched = read_counts()
            masks = latte_pab_masks(pab, pipe.schedule.timesteps, 2)
    want, _ = latte_pab_launches(masks, ~mask[:, 0], depth=2)
    check_narrow("Latte PAB", outs["card"], outs["cpu"], launched, want)


# ------------------------------------------ Open-Sora-Plan and CogVideoX
# Open-Sora-Plan v1.2: 28 blocks per trunk run. Packed: K7 qkv and ff1, K1
# (full 3-D attention, head dim 72 padded), K8 proj and ff2, K6; unpacked
# (and PAB's computed sites): K3 before the attention and the MLP, K1 for
# the self- and the cross-attention
OSP_TRUNK_LAUNCHES = {
    "packed": dict(NO_LAUNCHES, lnmod_matmul=56, flash_attention_bshd=28,
                   matmul_gated_residual=56, fused_cross_attention=28),
    "unpacked": dict(NO_LAUNCHES, layer_norm_mod=56, flash_attention_bshd=56)}
OSP_CAP = 512
OSP_FRAMES, OSP_GRID = 93, (24, 30, 40)          # 93x480x640: 28,800 tokens
OSP_REQ_FRAMES, OSP_REQ_GRID, OSP_STEPS = 29, (8, 30, 40), 30   # 9,600 tokens
# v1.1: the Latte trunk at 65 frames (17 latent frames of 32 x 32 patches);
# its temporal groups of 17 take K5r's "tma" body, as the spatial frames do
V110_FRAMES, V110_GRID, V110_STEPS = 65, (17, 32, 32), 20
V110_ROUTES = dict(NO_ROUTES, tma=56)
# CogVideoX-5B: 42 joint blocks, K1 (head dim 64 padded) once each
COG_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=42)
COG_TXT = 226
COG_FRAMES, COG_GRID = 49, (13, 30, 45)          # 17,550 video + 226 text tokens
COG_REQ_FRAMES, COG_REQ_GRID, COG_STEPS = 13, (4, 30, 45), 20  # 5,400 video tokens
# the CogVideoX VAE needs an odd latent frame count (13 frames would decode to
# 16): the request that ends in pixels takes 17 frames, 5 latent frames
COG_PX_FRAMES, COG_PX_GRID = 17, (5, 30, 45)


def phase_osp_kernels(dev, rec):
    """K1, K7, K8 and K6 at Open-Sora-Plan v1.2's 93x480x640 shapes, K5r over
    v1.1's temporal groups of 17 and K6 at its 65x512x512 shapes, each vs its
    plain version (bf16)."""
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    log("phase 39: kernels vs plain at Open-Sora-Plan v1.2 93x480x640 and v1.1 "
        "65x512x512 shapes (bf16)")
    gen = torch.Generator(device=dev).manual_seed(3939)
    rows, H, D = 2, 16, 72
    d = H * D
    N = math.prod(OSP_GRID)

    def rnd(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # K1: the full 3-D self-attention over 28,800 tokens, running max
    label = f"running max, OSP v1.2 3-D {rows}x{N}x{H}x72 -> 128"
    k1_check(rec, f"K1 [{label}]", label, rnd(rows, N, H, D), rnd(rows, N, H, D),
             rnd(rows, N, H, D), None, big=True)

    # K7 (qkv; ff1 with gelu) and K8 (proj; ff2, both with the residual)
    h = rnd(rows, N, d)
    sc, sh = rnd(rows, d, dtype=torch.float32, scale=0.1), rnd(rows, d, dtype=torch.float32,
                                                                scale=0.1)
    for label, wide, kw in ((f"OSP qkv {rows}x{N}x{d} -> {3 * d}", 3 * d, {}),
                            (f"OSP ff1 {rows}x{N}x{d} -> {4 * d}, gelu", 4 * d,
                             dict(act="gelu"))):
        w, b = rnd(wide, d, scale=d ** -0.5), rnd(wide, scale=0.1)
        got = P.lnmod_matmul(h, sc, sh, w, b, **kw)
        want, pms = timed_once(lambda: P.lnmod_matmul_plain(h, sc, sh, w, b, **kw))
        record(rec, "lnmod_matmul", label, got, want,
               cuda_ms(lambda: P.lnmod_matmul(h, sc, sh, w, b, **kw)), pms,
               2 * rows * N * d * wide, nbytes(h, w, b, got))
        del got, want
    g = rnd(rows, d, dtype=torch.float32, scale=0.5)
    for label, wide in ((f"OSP proj {rows}x{N}x{d} + resid", d),
                        (f"OSP ff2 {rows}x{N}x{4 * d} + resid", 4 * d)):
        x, w, b = rnd(rows, N, wide), rnd(d, wide, scale=wide ** -0.5), rnd(d, scale=0.1)
        got = P.matmul_gated_residual(x, w, b, g, h)
        want, pms = timed_once(lambda: P.matmul_gated_residual_plain(x, w, b, g, h))
        record(rec, "matmul_gated_residual", label, got, want,
               cuda_ms(lambda: P.matmul_gated_residual(x, w, b, g, h)), pms,
               2 * rows * N * wide * d, nbytes(x, w, b, got, h))
        del got, want, x

    # K6 over 512 caption keys (four whole key tiles): v1.2's 2 x 28,800
    # and v1.1's 2 x 17,408 queries
    wq, wo = rnd(d, d, scale=d ** -0.5), rnd(d, d, scale=d ** -0.5)
    bq, bo = rnd(d, scale=0.05), rnd(d, scale=0.05)
    k, v = rnd(rows, OSP_CAP, d), rnd(rows, OSP_CAP, d)
    kw = dict(scale=D ** -0.5, true_d=D, residual=True)
    for n, what in ((N, "v1.2"), (math.prod(V110_GRID), "v1.1")):
        x = h[:, :n].contiguous()
        got = A.fused_cross_attention(x, wq, bq, k, v, wo, bo, H, **kw)
        want, pms = timed_once(lambda: A.fused_cross_attention_plain(x, wq, bq, k, v, wo,
                                                                     bo, H, **kw))
        record(rec, "fused_cross_attention", f"OSP {what} {rows}x{n} x {OSP_CAP} keys, "
               f"residual", got, want,
               cuda_ms(lambda: A.fused_cross_attention(x, wq, bq, k, v, wo, bo, H, **kw)),
               pms, 4 * rows * n * d * d + 4 * rows * n * OSP_CAP * d,
               nbytes(x, wq, bq, k, v, wo, bo, got))
        del got, want, x
    del h

    # K5r over v1.1's temporal groups of 17 (the "tma" body), beside SDPA
    # with the frames as the batch
    T, S = V110_GRID[0], V110_GRID[1] * V110_GRID[2]
    qkv = rnd(1, rows * S * T, 3 * d)
    before = dict(A._grouped_launch.routes)
    kw = dict(group=T, scale=D ** -0.5)
    got = A.grouped_attention_fused_qkv(qkv, H, **kw)
    if A._grouped_launch.routes["tma"] != before["tma"] + 1:
        fail("K5r over groups of 17 did not take the tma route")
    want, pms = timed_once(lambda: A.grouped_attention_fused_qkv_plain(qkv, H, **kw))
    q, kk, vv = qkv.reshape(rows * S, T, 3, H, D).unbind(2)
    record(rec, "grouped_attention_fused_qkv_rowmax",
           f"OSP v1.1 temporal {rows * S * T} rows, group {T}, route tma", got, want,
           cuda_ms(lambda: A.grouped_attention_fused_qkv(qkv, H, **kw)), pms,
           4 * rows * S * H * T * T * D, nbytes(qkv, got),
           library=("F.scaled_dot_product_attention", sdpa_ms(q, kk, vv, 20)))
    del qkv, got, want, q, kk, vv


def make_osp_model(dev):
    from magcache_tpu_torch.models.open_sora_plan import OSP_V120, OSPModel

    cfg = dataclasses.replace(OSP_V120, dtype="bfloat16")
    t0 = time.time()
    model = OSPModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  Open-Sora-Plan v1.2 bf16 random init: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def profile_forward(label: str, core, x, t, cond, top: int = 10) -> None:
    """One forward (prepare -> trunk -> head) under ``torch.profiler`` (CPU
    and CUDA): the wall time, the summed device time, the device's idle
    share and the ``top`` device-time entries, as
    ``tools/profile_torch_forward.py`` prints them."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        hidden, c = core.prepare(x, t, cond)
        core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_time_total > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    log(f"  {label} profiled: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms, idle "
        f"share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        ms = e.device_time_total / 1e3
        log(f"    {ms:9.2f} ms  {100 * ms / busy_ms:5.1f}%  x{e.count:<5d} {e.key[:80]}")


def timed_forwards(core, x, t, cond, label, runs=2):
    """``runs`` forwards (prepare -> trunk -> head), each timed; returns the
    last output after checking it is finite and of x's shape (C channels)."""
    for run in range(runs):
        torch.cuda.synchronize()
        t0 = time.time()
        hidden, c = core.prepare(x, t, cond)
        out = core.head(core.trunk(hidden, c), c)
        torch.cuda.synchronize()
        log(f"  {label} forward (call {run + 1}): {time.time() - t0:.3f} s, "
            f"{hidden.shape[1]} tokens x {hidden.shape[0]} rows in the trunk")
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        fail(f"{label}: forward output {tuple(out.shape)} is not finite or misshapen")
    return out


def phase_osp_forward(dev, model):
    """Returns the forwards' launches."""
    from magcache_tpu_torch.models.open_sora_plan import make_osp_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    log(f"phase 40: full-shape forwards of Open-Sora-Plan v1.2 {OSP_FRAMES}x480x640 "
        f"(latent patches {OSP_GRID}: {math.prod(OSP_GRID)} tokens), 2 CFG rows, 28 blocks, "
        f"packed route")
    gen = torch.Generator(device=dev).manual_seed(40)
    T, gh, gw = OSP_GRID
    x = torch.randn((2, T, 2 * gh, 2 * gw, 4), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"y": MockTextEncoder(OSP_CAP, 4096, scale=0.5)(["a boat", ""], device=dev)}
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    core = make_osp_core(model, OSP_GRID, OSP_CAP, route="packed")
    out = timed_forwards(core, x, t, cond, "OSP v1.2 packed")
    log(f"  output std {float(out.float().std()):.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    counts = check_forward_counts("OSP v1.2 packed", 2, OSP_TRUNK_LAUNCHES["packed"],
                                  NO_ROUTES)
    if k1_modes() != {"fixed": 0, "running": 56}:
        fail(f"OSP v1.2: K1 by shift {k1_modes()}, not 28 running a forward")
    profile_forward("OSP v1.2 packed forward", core, x, t, cond)
    return counts


def request_checks(label, out, want_skips, shape, per_run, routes=None):
    """Checks a request's latents (finite, ``shape``), its realized skip bits
    (``want_skips``; a calibration request has none and computes every one
    of ``len(want_skips)`` steps) and the launches since the last
    ``reset_counts`` against ``per_run`` per trunk run (a step where some
    lane computes), and the grouped routes against ``routes`` per run when
    given; returns the launches."""
    from magcache_tpu_torch.ops import attention as A

    lat = out.latents
    if tuple(lat.shape) != shape or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
    skips = want_skips if out.skips is None else out.skips
    if not np.array_equal(skips, want_skips):
        fail(f"{label}: realized skips differ from compute_skip_schedule")
    runs = int((~skips.all(1)).sum())
    launched = read_counts()
    if launched != {k: n * runs for k, n in per_run.items()}:
        fail(f"{label}: launches {launched} != {per_run} x {runs} trunk runs")
    got = dict(A._grouped_launch.routes)
    if routes is not None and got != {k: n * runs for k, n in routes.items()}:
        fail(f"{label}: grouped routes {got} != {routes} x {runs}")
    log(f"  {label}: {out.timings['total_s']:.3f} s/video, {runs} of {len(skips)} model "
        f"calls computed, skips per lane {skips.sum(0).tolist()}, latents std "
        f"{float(lat.float().std()):.4f}")
    return launched


def pab_request(label, module, per_block, pipe, prompt, masks, sites):
    """A PAB request with the sites' reuse counted at each site
    (``pab_site_spy``); fails unless each site in ``sites`` (``{name:
    (position, kind, mask key, per-step count)}``) reused on exactly the
    steps its mask says. Returns the output and the peak memory in GB."""
    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(pipe.device)
    spied, uninstall = pab_site_spy(module, per_block)
    try:
        out = pipe.generate(prompt, seed=3)
    finally:
        uninstall()
    peak = torch.cuda.max_memory_allocated(pipe.device) / 1e9
    got = {name: spied.get((pos, kind), [0, 0, 0])[1] // per
           for name, (pos, kind, _, per) in sites.items()}
    expect = {name: int(np.asarray(masks[key]).sum()) for name, (_, _, key, _) in sites.items()}
    log(f"  {label}: reuse steps per site {got}; the masks {expect}; peak memory {peak:.2f} GB")
    if got != expect:
        fail(f"{label}: site reuse {got} != the masks' {expect}")
    return out, peak


def osp_pab_launches(masks: dict, depth: int = 28) -> dict:
    """Launches of v1.2's PAB trunk runs (the unpacked sites; every step
    runs the trunk): K3 before each computed attention and MLP, K1 for each
    computed self- and cross-attention."""
    want = dict(NO_LAUNCHES)
    for i in range(len(masks["spatial"])):
        sp, cr, ml = (not masks[k][i] for k in ("spatial", "cross", "mlp"))
        want["layer_norm_mod"] += depth * (sp + ml)
        want["flash_attention_bshd"] += depth * (sp + cr)
    return want


def phase_osp_requests(dev, model):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.core.pab import broadcast_masks
    from magcache_tpu_torch.models import open_sora_plan as OM
    from magcache_tpu_torch.pipelines.open_sora_plan import (OpenSoraPlanPipeline,
                                                             OpenSoraPlanPipelineConfig)

    log(f"phase 41: requests through OpenSoraPlanPipeline.generate (v120), "
        f"{OSP_REQ_FRAMES}x480x640 ({math.prod(OSP_REQ_GRID)} tokens), {OSP_STEPS} "
        f"Euler-Ancestral steps (cut from 150), guidance 7.5: full compute, MagCache "
        f"(0.12 / K 3 / R 0.2, flat ratios), calibration and its ratios installed, PAB")
    base = dict(num_frames=OSP_REQ_FRAMES, num_inference_steps=OSP_STEPS, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    shape = (1, OSP_REQ_GRID[0], 60, 80, 4)
    per_run = OSP_TRUNK_LAUNCHES["packed"]
    total = dict(NO_LAUNCHES)

    def run(label, **kw):
        pipe = OpenSoraPlanPipeline(OpenSoraPlanPipelineConfig(**base, **kw), dev,
                                    model=model)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = pipe.generate(prompt, seed=3)
        cache = pipe._cache_cfg()
        want = (compute_skip_schedule(cache).reshape(OSP_STEPS, 2) if cache is not None
                else np.zeros((OSP_STEPS, 1), bool))
        launched = request_checks(label, out, want, shape, per_run)
        log(f"    peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        for k, n in launched.items():
            total[k] += n
        return out

    full = run("full compute")
    run("MagCache E012K3R02, flat ratios", use_magcache=True)
    cal = run("calibration (full compute)", magcache_calibration=True)
    ratios = tuple(cal.calibration["norm_ratio"])
    if len(ratios) != 2 * (OSP_STEPS - 1) or not np.all(np.isfinite(ratios)):
        fail(f"calibration recorded {len(ratios)} ratios, or non-finite ones")
    log(f"  norm_ratio (2 lanes) {np.round(ratios[:4], 4).tolist()} ... "
        f"{np.round(ratios[-4:], 4).tolist()}")
    run("MagCache with the recorded ratios", use_magcache=True, magcache_ratios=ratios)
    pipe = OpenSoraPlanPipeline(OpenSoraPlanPipelineConfig(**base, enable_pab=True), dev,
                                model=model)
    masks = broadcast_masks(pipe.config.pab(), pipe.schedule.timesteps)
    out, _ = pab_request("PAB (v1.2 windows: spatial + cross)", OM, 3, pipe, prompt, masks,
                         {"spatial": (0, "attn", "spatial", 28),
                          "cross": (1, "cross", "cross", 28)})
    launched = read_counts()
    if launched != osp_pab_launches(masks):
        fail(f"OSP PAB: launches {launched} != {osp_pab_launches(masks)}")
    for k, n in launched.items():
        total[k] += n
    log(f"  PAB: {out.timings['total_s']:.3f} s/video, rel L2 against full compute "
        f"{rel_l2(out.latents, full.latents):.3e}, launches {launched}")
    log(f"  launches in phase 41: {total}")
    return total


def v110_pab_launches(masks: dict, depth: int = 28):
    """Launches and K5r routes of v1.1's PAB trunk runs (Latte's PAB block,
    every step): ``latte_pab_launches`` with the temporal groups of 17 on
    the "tma" body."""
    want, routes = latte_pab_launches(masks, np.ones(len(masks["spatial"]), bool), depth)
    return want, dict(routes, tma=routes["tma"] + routes["stream"], stream=0)


def phase_v110_requests(dev):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.core.pab import OSP_V110_PAB
    from magcache_tpu_torch.models import latte as LM
    from magcache_tpu_torch.pipelines.open_sora_plan import (OpenSoraPlanPipeline,
                                                             OpenSoraPlanPipelineConfig)

    n_calls = V110_STEPS + 1
    log(f"phase 42: requests through OpenSoraPlanPipeline.generate (v110: the Latte-1 "
        f"trunk, 8 output channels), {V110_FRAMES}x512x512 ({V110_GRID[0]} latent frames "
        f"of {V110_GRID[1] * V110_GRID[2]} tokens), PNDM {V110_STEPS} steps (cut from "
        f"150; {n_calls} model calls), caption 512: full compute, MagCache, PAB")
    model = make_latte_model(dev)
    base = dict(version="v110", num_frames=V110_FRAMES, height=512, width=512,
                num_inference_steps=V110_STEPS, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    shape = (1,) + V110_GRID[:1] + (64, 64, 4)
    per_run = LATTE_TRUNK_LAUNCHES["packed"]
    total = dict(NO_LAUNCHES)
    lats = {}
    for label, kw in (("full compute", {}), ("MagCache E012K3R02, flat ratios",
                                             dict(use_magcache=True))):
        pipe = OpenSoraPlanPipeline(OpenSoraPlanPipelineConfig(**base, **kw), dev,
                                    model=model)
        reset_counts()
        out = pipe.generate(prompt, seed=3)
        cache = pipe._cache_cfg()
        want = (compute_skip_schedule(cache).reshape(n_calls, 2) if cache is not None
                else np.zeros((n_calls, 1), bool))
        launched = request_checks(label, out, want, shape, per_run, V110_ROUTES)
        lats[label] = out.latents
        for k, n in launched.items():
            total[k] += n
    # OSP_V110_PAB's windows; its MLP anchors (every 24 timesteps from 738 at
    # 150 steps: save, reuse twice, compute) moved onto the 20-step grid of
    # multiples of 50 (every 200 from 700) so that they fire
    anchors = tuple((t, tuple(range(7)), 2) for t in (700, 500))
    pab = dataclasses.replace(OSP_V110_PAB, mlp_spatial_config=anchors,
                              mlp_temporal_config=anchors)
    pipe = OpenSoraPlanPipeline(OpenSoraPlanPipelineConfig(**base, enable_pab=True,
                                                           pab_config=pab), dev, model=model)
    masks = LM.latte_pab_masks(pab, pipe.schedule.timesteps, 28)
    out, _ = pab_request("PAB (OSP_V110_PAB, MLP anchors 700 and 500 on blocks 0-6)", LM, 5,
                         pipe, prompt,
                         dict(masks, mlp_sp=masks["mlp_sp_reuse"], mlp_tp=masks["mlp_tp_reuse"]),
                         {"spatial": (0, "attn", "spatial", 28),
                          "temporal": (3, "attn", "temporal", 28),
                          "cross": (1, "cross", "cross", 28),
                          "mlp spatial": (2, "mlp", "mlp_sp", 1),
                          "mlp temporal": (4, "mlp", "mlp_tp", 1)})
    launched = read_counts()
    want, routes = v110_pab_launches(masks)
    check_launch_routes("OSP v1.1 PAB", launched, want, routes)
    for k, n in launched.items():
        total[k] += n
    log(f"  PAB: {out.timings['total_s']:.3f} s/video, rel L2 against full compute "
        f"{rel_l2(out.latents, lats['full compute']):.3e}, launches {launched}")
    log(f"  launches in phase 42: {total}")
    return total


def make_cogvideox_model(dev):
    from magcache_tpu_torch.models.cogvideox import COGVIDEOX_5B, CogVideoXModel

    cfg = dataclasses.replace(COGVIDEOX_5B, dtype="bfloat16")
    t0 = time.time()
    model = CogVideoXModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"  CogVideoX-5B bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{n / 1e9:.3f} B params ({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
        f"allocated)")
    return model


def phase_cogvideox_forward(dev, rec, model):
    """K1 at the 5B forward's joint shape vs its plain version, then two
    full-shape forwards; returns their launches."""
    from magcache_tpu_torch.models.cogvideox import make_cogvideox_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    n_vid = math.prod(COG_GRID)
    log(f"phase 43: CogVideoX-5B at {COG_FRAMES}x480x720 (latent patches {COG_GRID}: "
        f"{n_vid} video + {COG_TXT} text tokens), 2 CFG rows, 42 blocks: K1 vs plain at "
        f"the joint shape, then full-shape forwards")
    gen = torch.Generator(device=dev).manual_seed(43)
    s = n_vid + COG_TXT
    label = f"running max, CogVideoX joint 2x{s}x48x64 -> 128"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    k1_check(rec, f"K1 [{label}]", label, rnd(2, s, 48, 64), rnd(2, s, 48, 64),
             rnd(2, s, 48, 64), None, big=True)
    T, gh, gw = COG_GRID
    x = torch.randn((2, T, 2 * gh, 2 * gw, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = {"txt": MockTextEncoder(COG_TXT, 4096, scale=0.5)(["a boat", ""], device=dev)}
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    core = make_cogvideox_core(model, COG_TXT, COG_GRID)
    out = timed_forwards(core, x, t, cond, "CogVideoX-5B")
    log(f"  output std {float(out.float().std()):.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    counts = check_forward_counts("CogVideoX-5B", 2, COG_TRUNK_LAUNCHES, NO_ROUTES)
    if k1_modes() != {"fixed": 0, "running": 84}:
        fail(f"CogVideoX: K1 by shift {k1_modes()}, not 42 running a forward")
    profile_forward("CogVideoX-5B forward", core, x, t, cond)
    return counts


def phase_cogvideox_requests(dev, model):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.pab import COGVIDEOX_PAB, broadcast_masks
    from magcache_tpu_torch.models import cogvideox as CM
    from magcache_tpu_torch.pipelines.cogvideox import (CogVideoXPipeline,
                                                        CogVideoXPipelineConfig)

    log(f"phase 44: requests through CogVideoXPipeline.generate, {COG_REQ_FRAMES}x480x720 "
        f"(frames cut from 49: {math.prod(COG_REQ_GRID)} video tokens), {COG_STEPS} DDIM "
        f"steps (cut from 50), guidance 6.0: full compute, MagCache (0.12 / K 3 / R 0.2, "
        f"flat ratios), dynamic CFG with MagCache, PAB (COGVIDEOX_PAB)")
    base = dict(num_frames=COG_REQ_FRAMES, num_inference_steps=COG_STEPS, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    shape = (1,) + COG_REQ_GRID[:1] + (60, 90, 16)
    total = dict(NO_LAUNCHES)
    lats = {}
    for label, kw in (("full compute", {}),
                      ("MagCache E012K3R02, flat ratios", dict(use_magcache=True)),
                      ("dynamic CFG + MagCache", dict(use_dynamic_cfg=True,
                                                      use_magcache=True))):
        pipe = CogVideoXPipeline(CogVideoXPipelineConfig(**base, **kw), dev, model=model)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = pipe.generate(prompt, seed=3)
        want = pipe.skip_mask_for(use_magcache=bool(kw.get("use_magcache")))
        launched = request_checks(label, out, want, shape, COG_TRUNK_LAUNCHES)
        log(f"    peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        if kw.get("use_dynamic_cfg"):
            gs = pipe.guidance_scales()
            log(f"    dynamic guidance {gs[0]:.4f} -> {gs[-1]:.4f} over the steps")
        lats[label] = out.latents
        for k, n in launched.items():
            total[k] += n
    pipe = CogVideoXPipeline(CogVideoXPipelineConfig(**base, enable_pab=True), dev,
                             model=model)
    masks = broadcast_masks(COGVIDEOX_PAB, pipe.schedule.timesteps.astype(np.float32))
    out, _ = pab_request("PAB (COGVIDEOX_PAB)", CM, 2, pipe, prompt, masks,
                         {"spatial": (0, "attn", "spatial", 42)})
    launched = read_counts()
    want = dict(NO_LAUNCHES, flash_attention_bshd=42 * int((~masks["spatial"]).sum()))
    if launched != want:
        fail(f"CogVideoX PAB: launches {launched} != {want}")
    for k, n in launched.items():
        total[k] += n
    log(f"  PAB: {out.timings['total_s']:.3f} s/video, rel L2 against full compute "
        f"{rel_l2(out.latents, lats['full compute']):.3e}, launches {launched}")
    log(f"  launches in phase 44: {total}")
    return total


def _numpy_osp_tree(cfg, rng):
    """A random Open-Sora-Plan v1.2 parameter tree in the JAX package's
    layout (depth-stacked blocks, ``w: [d_in, d_out]``)."""
    d, L = cfg.hidden, cfg.depth

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    blocks = {n: lin(d, w * d, L) for n, w in (("qkv", 3), ("proj", 1), ("cross_q", 1),
                                               ("cross_kv", 2), ("cross_o", 1),
                                               ("ff1", cfg.mlp_ratio))}
    blocks["ff2"] = lin(cfg.mlp_ratio * d, d, L)
    blocks["scale_shift"] = rng.standard_normal((L, 6, d)) / math.sqrt(d)
    return {"patch_embed": lin(cfg.patch_in, d),
            "caption": {"in": lin(cfg.caption_dim, d), "out": lin(d, d)},
            "time": {"in": lin(cfg.time_embed_dim, d), "out": lin(d, d)},
            "adaln_single": lin(d, 6 * d), "blocks": blocks,
            "final_mod": rng.standard_normal((2, d)) / math.sqrt(d),
            "final_out": lin(d, cfg.c_out * math.prod(cfg.patch))}


def _numpy_cogvideox_tree(cfg, rng):
    """A random CogVideoX parameter tree in the JAX package's layout, the
    norms' affines near 1 and 0."""
    d, L, ct, hd = cfg.hidden, cfg.layers, cfg.cond_dim, cfg.head_dim

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def near(shape, v):
        return v + 0.1 * rng.standard_normal(shape)

    blocks = {"mod1": lin(ct, 6 * d, L), "mod2": lin(ct, 6 * d, L), "qkv": lin(d, 3 * d, L),
              "proj": lin(d, d, L), "ff1": lin(d, cfg.mlp_ratio * d, L),
              "ff2": lin(cfg.mlp_ratio * d, d, L)}
    for name, n, v in (("ln1_w", d, 1.0), ("ln1_b", d, 0.0), ("ln2_w", d, 1.0),
                       ("ln2_b", d, 0.0), ("q_norm_w", hd, 1.0), ("q_norm_b", hd, 0.0),
                       ("k_norm_w", hd, 1.0), ("k_norm_b", hd, 0.0)):
        blocks[name] = near((L, n), v)
    return {"patch_embed": lin(cfg.in_channels * cfg.patch ** 2, d),
            "text_proj": lin(cfg.text_dim, d),
            "time": {"in": lin(cfg.time_embed_dim, ct), "out": lin(ct, ct)},
            "blocks": blocks, "norm_final_w": near(d, 1.0), "norm_final_b": near(d, 0.0),
            "norm_out_w": near(d, 1.0), "norm_out_b": near(d, 0.0),
            "final_mod": lin(ct, 2 * d), "final_out": lin(d, cfg.in_channels * cfg.patch ** 2)}


def phase_osp_cogvideox_card_vs_cpu(dev):
    """Narrow Open-Sora-Plan v1.2 (both routes), v1.1 and CogVideoX through
    their pipelines with MagCache (flat ratios: some steps skip), bf16 on
    the card against f32 on the CPU."""
    from magcache_tpu_torch.models.cogvideox import CogVideoXConfig, CogVideoXModel
    from magcache_tpu_torch.models.convert import (cogvideox_params_from_numpy,
                                                   latte_params_from_numpy,
                                                   osp_params_from_numpy)
    from magcache_tpu_torch.models.latte import LatteConfig, LatteModel
    from magcache_tpu_torch.models.open_sora_plan import OpenSoraPlanConfig, OSPModel
    from magcache_tpu_torch.pipelines.cogvideox import (CogVideoXPipeline,
                                                        CogVideoXPipelineConfig)
    from magcache_tpu_torch.pipelines.open_sora_plan import (OpenSoraPlanPipeline,
                                                             OpenSoraPlanPipelineConfig)

    log("phase 45: narrow Open-Sora-Plan v1.2 (packed and unpacked), v1.1 (17 latent "
        "frames) and CogVideoX on the card (kernels, bf16) vs the CPU (plain, f32), "
        "MagCache with skipped steps")
    osp = OpenSoraPlanConfig(hidden=144, heads=2, depth=2, caption_dim=64, time_embed_dim=64,
                             out_channels=8)
    latte = LatteConfig(hidden=144, heads=2, depth=2, caption_dim=64, time_embed_dim=64,
                        out_channels=8)
    cog = CogVideoXConfig(hidden=128, heads=2, layers=2, text_dim=64, time_embed_dim=64)
    mag = dict(use_magcache=True, magcache_thresh=0.3)
    cases = (
        # 9 frames at 128x128: 3 latent frames of 64 patches (192 tokens > 128: K1)
        ("OSP v1.2 packed", osp, OSPModel, osp_params_from_numpy, _numpy_osp_tree,
         OpenSoraPlanPipeline, OpenSoraPlanPipelineConfig,
         dict(num_frames=9, height=128, width=128, num_inference_steps=8, caption_len=20,
              route="packed", **mag), OSP_TRUNK_LAUNCHES["packed"], 28),
        ("OSP v1.2 unpacked", osp, OSPModel, osp_params_from_numpy, _numpy_osp_tree,
         OpenSoraPlanPipeline, OpenSoraPlanPipelineConfig,
         dict(num_frames=9, height=128, width=128, num_inference_steps=8, caption_len=20,
              route="unpacked", **mag), OSP_TRUNK_LAUNCHES["unpacked"], 28),
        # 65 frames: 17 latent frames of 64 patches, K5r "tma" both ways
        ("OSP v1.1", latte, LatteModel, latte_params_from_numpy, _numpy_latte_tree,
         OpenSoraPlanPipeline, OpenSoraPlanPipelineConfig,
         dict(version="v110", num_frames=65, height=128, width=128, num_inference_steps=6,
              caption_len=20, **mag), LATTE_TRUNK_LAUNCHES["packed"], 28),
        ("CogVideoX", cog, CogVideoXModel, cogvideox_params_from_numpy,
         _numpy_cogvideox_tree, CogVideoXPipeline, CogVideoXPipelineConfig,
         dict(num_frames=9, height=128, width=128, num_inference_steps=8, txt_len=20,
              **mag), COG_TRUNK_LAUNCHES, 42))
    for label, cfg, cls, convert, tree_fn, pipe_cls, pipe_cfg, kw, trunk, depth in cases:
        tree = tree_fn(cfg, np.random.default_rng(45))
        outs = {}
        reset_counts()
        for name, device, dtype in (("card", dev, "bfloat16"),
                                    ("cpu", torch.device("cpu"), "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = cls(c, device)
            model.load_state_dict(convert(tree, c, device))
            pipe = pipe_cls(pipe_cfg(dtype=dtype, **kw), device, model=model)
            out = pipe.generate("a red boat", seed=4)
            outs[name] = out.latents.float().cpu()
            if name == "card":
                launched = read_counts()
                skips = out.skips
        runs = int((~skips.all(1)).sum())
        if not skips.any() or runs == len(skips):
            fail(f"{label}: no step skipped, or every step did")
        check_narrow(label, outs["card"], outs["cpu"], launched,
                     {k: n * 2 // depth * runs for k, n in trunk.items()})
        log(f"    {label}: {runs} of {len(skips)} model calls computed")



# ------------------------------------------------- Vchitect-XL and the VAEs
# Vchitect-XL-2B: 23 joint blocks and the context-pre-only last; K1 (head dim
# 64 padded) for each block's spatial and cross attention; the temporal one
# over the frames takes attention()'s einsum path
VCH_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=48)
VCH_TXT = 77
VCH_FRAMES, VCH_GRID = 40, (40, 30, 48)      # 1,440 video + 77 text tokens a frame
VCH_REQ_FRAMES, VCH_REQ_GRID, VCH_STEPS = 16, (16, 30, 48), 20
SD3_T5_LEN = 256                             # the SD3 stack's T5 length
VCH_SD3_TXT = 77 + SD3_T5_LEN                # its context: CLIP 77 + T5 256 tokens


def phase_vchitect_kernels(dev, rec):
    log("phase 46: K1 at Vchitect-XL's 40x480x768 shapes with the mock's 77 context tokens "
        f"and the SD3 stack's {VCH_SD3_TXT}, running max, head dim 64 padded to 128 (bf16)")
    gen = torch.Generator(device=dev).manual_seed(4646)
    T, gh, gw = VCH_GRID
    j = gh * gw + VCH_TXT

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    label = f"running max, Vchitect spatial {2 * T}x{j}x24x64 -> 128"
    k1_check(rec, f"K1 [{label}]", label, rnd(2 * T, j, 24, 64), rnd(2 * T, j, 24, 64),
             rnd(2 * T, j, 24, 64), None, big=True)
    label = f"running max, Vchitect cross 2x{T * j}x24x64 x {VCH_TXT} keys -> 128"
    k1_check(rec, f"K1 [{label}]", label, rnd(2, T * j, 24, 64), rnd(2, VCH_TXT, 24, 64),
             rnd(2, VCH_TXT, 24, 64), None, big=True)
    # the SD3 stack's context (phase 53's request): 77 + 256 tokens a frame
    j = gh * gw + VCH_SD3_TXT
    label = f"running max, Vchitect spatial at the SD3 context {2 * T}x{j}x24x64 -> 128"
    k1_check(rec, f"K1 [{label}]", label, rnd(2 * T, j, 24, 64), rnd(2 * T, j, 24, 64),
             rnd(2 * T, j, 24, 64), None, big=True)
    label = (f"running max, Vchitect cross at the SD3 context 2x{T * j}x24x64 x "
             f"{VCH_SD3_TXT} keys -> 128")
    k1_check(rec, f"K1 [{label}]", label, rnd(2, T * j, 24, 64), rnd(2, VCH_SD3_TXT, 24, 64),
             rnd(2, VCH_SD3_TXT, 24, 64), None, big=True)


def make_vchitect_model(dev):
    from magcache_tpu_torch.models.vchitect import VCHITECT_XL, VchitectModel

    cfg = dataclasses.replace(VCHITECT_XL, dtype="bfloat16")
    t0 = time.time()
    model = VchitectModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize()
    log(f"  Vchitect-XL bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params")
    return model


def vchitect_cond(dev, txt_len=VCH_TXT, text_dim=4096, vec_dim=2048):
    from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder

    prompts = ["a boat", ""]
    return {"txt": MockTextEncoder(txt_len, text_dim, scale=0.5)(prompts, device=dev),
            "vec": MockPooledEncoder(vec_dim)(prompts, device=dev)}


def phase_vchitect_forward(dev, model):
    """Returns the forwards' launches."""
    from magcache_tpu_torch.models.vchitect import make_vchitect_core

    T, gh, gw = VCH_GRID
    log(f"phase 47: full-shape forwards of Vchitect-XL-2B at {VCH_FRAMES}x480x768 (latent "
        f"patches {VCH_GRID}: {gh * gw} video + {VCH_TXT} text tokens a frame), 2 CFG rows, "
        f"24 blocks")
    gen = torch.Generator(device=dev).manual_seed(47)
    x = torch.randn((2, T, 2 * gh, 2 * gw, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    cond = vchitect_cond(dev)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    core = make_vchitect_core(model, VCH_GRID, VCH_TXT)
    out = timed_forwards(core, x, t, cond, "Vchitect-XL")
    log(f"  output std {float(out.float().std()):.4f}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    counts = check_forward_counts("Vchitect-XL", 2, VCH_TRUNK_LAUNCHES, NO_ROUTES)
    if k1_modes() != {"fixed": 0, "running": 96}:
        fail(f"Vchitect: K1 by shift {k1_modes()}, not 48 running a forward")
    profile_forward("Vchitect-XL forward", core, x, t, cond)
    return counts


def phase_vchitect_requests(dev, model):
    """Returns the phase's launches."""
    from magcache_tpu_torch.core.pab import broadcast_masks
    from magcache_tpu_torch.models import vchitect as VM
    from magcache_tpu_torch.pipelines.vchitect import VchitectPipeline, VchitectPipelineConfig

    log(f"phase 48: requests through VchitectPipeline.generate, {VCH_REQ_FRAMES}x480x768 "
        f"(frames cut from 40: {math.prod(VCH_REQ_GRID)} video tokens), {VCH_STEPS} "
        f"FlowMatch-Euler steps (cut from 100), guidance 7.5: full compute, MagCache (0.12 / "
        f"K 3 / R 0.2, flat ratios), calibration and its ratios installed, PAB")
    base = dict(num_frames=VCH_REQ_FRAMES, num_inference_steps=VCH_STEPS, dtype="bfloat16")
    prompt = "A red sailboat glides across a calm bay at dawn."
    shape = (1, VCH_REQ_FRAMES, 60, 96, 16)
    total = dict(NO_LAUNCHES)

    def run(label, **kw):
        pipe = VchitectPipeline(VchitectPipelineConfig(**base, **kw), dev, model=model)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = pipe.generate(prompt, seed=3)
        launched = request_checks(label, out, pipe.skip_mask_for(), shape, VCH_TRUNK_LAUNCHES)
        log(f"    peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        for k, n in launched.items():
            total[k] += n
        return out

    full = run("full compute")
    run("MagCache E012K3R02, flat ratios", use_magcache=True)
    cal = run("calibration (full compute)", magcache_calibration=True)
    ratios = tuple(cal.calibration["norm_ratio"])
    if len(ratios) != 2 * (VCH_STEPS - 1) or not np.all(np.isfinite(ratios)):
        fail(f"calibration recorded {len(ratios)} ratios, or non-finite ones")
    log(f"  norm_ratio (2 lanes) {np.round(ratios[:4], 4).tolist()} ... "
        f"{np.round(ratios[-4:], 4).tolist()}")
    run("MagCache with the recorded ratios", use_magcache=True, magcache_ratios=ratios)
    pipe = VchitectPipeline(VchitectPipelineConfig(**base, enable_pab=True), dev, model=model)
    masks = broadcast_masks(pipe.config.pab(), pipe.schedule.timesteps)
    out, _ = pab_request("PAB (spatial range 2, temporal range 4, in (100, 800))", VM, 3, pipe,
                         prompt, masks, {"temporal": (0, "temporal", "temporal", 24),
                                         "cross": (1, "cross", "cross", 24),
                                         "spatial": (2, "spatial", "spatial", 24)})
    launched = read_counts()
    want = dict(NO_LAUNCHES, flash_attention_bshd=24 * int(
        (~masks["spatial"]).sum() + (~masks["cross"]).sum()))
    if launched != want:
        fail(f"Vchitect PAB: launches {launched} != {want}")
    if tuple(out.latents.shape) != shape or not bool(torch.isfinite(out.latents).all()):
        fail("Vchitect PAB: latents not finite or misshapen")
    for k, n in launched.items():
        total[k] += n
    log(f"  PAB: {out.timings['total_s']:.3f} s/video, rel L2 against full compute "
        f"{rel_l2(out.latents, full.latents):.3e}, launches {launched}")
    log(f"  launches in phase 48: {total}")
    return total


def phase_vae_decodes(dev):
    """Returns the v1.2-layout OSP VAE and the CogVideoX VAE."""
    from magcache_tpu_torch.models.vae_cogvideox import CogVideoXVAE, CogVideoXVAEConfig
    from magcache_tpu_torch.models.vae_osp import OSP_V110_VAE, OSP_V120_VAE, OSPCausalVAE

    log("phase 49: f32 VAE decodes with random weights: Open-Sora-Plan CausalVAE v1.2 and "
        "v1.1 layouts (tiled), CogVideoX decode_tiled; one call each")
    gen = torch.Generator(device=dev).manual_seed(49)
    cases = (("OSP CausalVAE, v1.2 layout", OSPCausalVAE(OSP_V120_VAE, dev), "decode",
              (1, 24, 60, 80, 4), (1, 93, 480, 640, 3)),
             ("OSP CausalVAE, v1.1 layout", OSPCausalVAE(OSP_V110_VAE, dev), "decode",
              (1, 17, 64, 64, 4), (1, 65, 512, 512, 3)),
             ("CogVideoX VAE", CogVideoXVAE(CogVideoXVAEConfig(), dev), "decode_tiled",
              (1, 13, 60, 90, 16), (1, 49, 480, 720, 3)))
    vaes = []
    for label, vae, method, zshape, pshape in cases:
        vae.init(gen).requires_grad_(False)
        z = torch.randn(zshape, generator=gen, device=dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize()
        t0 = time.time()
        video = getattr(vae, method)(z)
        torch.cuda.synchronize()
        dt = time.time() - t0
        if tuple(video.shape) != pshape or not bool(torch.isfinite(video).all()):
            fail(f"{label}: pixels {tuple(video.shape)} not finite or not {pshape}")
        log(f"  {label}: {method} {zshape} -> {pshape} in {dt:.3f} s, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
            f"{sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M params, pixel std "
            f"{float(video.std()):.4f}")
        vaes.append(vae)
        del video
    return vaes[0], vaes[2]


def phase_pixel_requests(dev, osp_vae, cog_vae, osp_text):
    """Returns the Open-Sora-Plan and CogVideoX requests' launches; the
    Open-Sora-Plan request encodes its prompt with ``osp_text`` (phase 55's
    mT5-XXL)."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.cogvideox import CogVideoXPipeline, CogVideoXPipelineConfig
    from magcache_tpu_torch.pipelines.open_sora_plan import (OpenSoraPlanPipeline,
                                                             OpenSoraPlanPipelineConfig)

    log(f"phase 50: phase 41's and 44's MagCache requests once more, ending in pixels "
        f"(f32 VAEs of phase 49); Open-Sora-Plan from the prompt through phase 55's mT5-XXL, "
        f"CogVideoX (mock text) at {COG_PX_FRAMES} frames (an odd latent count)")
    prompt = TEXT_PROMPTS[0]
    out_counts = []
    for label, make, pipe_cls, cfg_cls, kw, vae, text, lat, pixels, per_run, skip_mask in (
            ("OSP v1.2", make_osp_model, OpenSoraPlanPipeline, OpenSoraPlanPipelineConfig,
             dict(num_frames=OSP_REQ_FRAMES, num_inference_steps=OSP_STEPS), osp_vae, osp_text,
             (1, OSP_REQ_GRID[0], 60, 80, 4), (1, OSP_REQ_FRAMES, 480, 640, 3),
             OSP_TRUNK_LAUNCHES["packed"],
             lambda p: compute_skip_schedule(p._cache_cfg()).reshape(OSP_STEPS, 2)),
            ("CogVideoX-5B", make_cogvideox_model, CogVideoXPipeline, CogVideoXPipelineConfig,
             dict(num_frames=COG_PX_FRAMES, num_inference_steps=COG_STEPS), cog_vae, None,
             (1, COG_PX_GRID[0], 60, 90, 16), (1, COG_PX_FRAMES, 480, 720, 3),
             COG_TRUNK_LAUNCHES, lambda p: p.skip_mask_for())):
        model = make(dev)                  # the seed of phases 40 and 43
        pipe = pipe_cls(cfg_cls(**kw, use_magcache=True, dtype="bfloat16"), dev, model=model,
                        vae=vae, text_encoder=text)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        out = pipe.generate(prompt, seed=3)
        counts = request_checks(f"{label} with pixels", out, skip_mask(pipe), lat, per_run)
        video = out.video
        if (video is None or tuple(video.shape) != pixels
                or not bool(torch.isfinite(video).all())):
            fail(f"{label}: video {None if video is None else tuple(video.shape)} missing, "
                 f"not {pixels} or not finite")
        if not out.timings["text_s"] > 0:
            fail(f"{label}: no text_s")
        log(f"    video {tuple(video.shape)} finite, std {float(video.std()):.4f}; text encode "
            f"{out.timings['text_s']:.3f} s and VAE decode {out.timings['decode_s']:.3f} s of "
            f"{out.timings['total_s']:.3f} s; peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
        out_counts.append(counts)
        del model, pipe, out, video
        torch.cuda.empty_cache()
    return out_counts


def _numpy_vchitect_tree(cfg, rng):
    """A random Vchitect-XL parameter tree in the JAX package's layout, with
    ``ot``, ``oc`` and ``add_out_t`` as random as the rest."""
    d, L, f = cfg.hidden, cfg.depth - 1, cfg.mlp_ratio * cfg.hidden

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    def block(depth, pre_only):
        p = {n: lin(d, d, depth) for n in ("q", "k", "v", "o", "qt", "kt", "vt", "ot", "qc",
                                           "oc", "add_q", "add_k", "add_v")}
        p.update(mod_x=lin(d, 6 * d, depth), ff1=lin(d, f, depth), ff2=lin(f, d, depth))
        if pre_only:
            p["mod_c2"] = lin(d, 2 * d, depth)
        else:
            p.update(mod_c=lin(d, 6 * d, depth), add_out=lin(d, d, depth),
                     add_out_t=lin(d, d, depth), ffc1=lin(d, f, depth), ffc2=lin(f, d, depth))
        return p

    return {"patch_embed": lin(cfg.in_channels * cfg.patch ** 2, d),
            "context_in": lin(cfg.text_dim, d),
            "time_in": {"in": lin(cfg.time_embed_dim, d), "out": lin(d, d)},
            "pooled_in": {"in": lin(cfg.vec_dim, d), "out": lin(d, d)},
            "blocks": block(L, False), "last": block(None, True),
            "norm_out_mod": lin(d, 2 * d), "proj_out": lin(d, cfg.in_channels * cfg.patch ** 2)}


def phase_vchitect_vae_card_vs_cpu(dev, osp_vae, cog_vae):
    """A narrow Vchitect through its pipeline with MagCache (flat ratios:
    some steps skip), bf16 on the card against f32 on the CPU; both VAEs at
    their published widths on narrow clips, f32 on the card and the CPU."""
    from magcache_tpu_torch.models.convert import vchitect_params_from_numpy
    from magcache_tpu_torch.models.vchitect import VchitectConfig, VchitectModel
    from magcache_tpu_torch.pipelines.vchitect import VchitectPipeline, VchitectPipelineConfig

    log("phase 51: narrow Vchitect on the card (K1, bf16) vs the CPU (plain, f32) with "
        "skipped steps; the VAEs' f32 decodes of narrow clips, card vs CPU")
    cfg = VchitectConfig(hidden=128, heads=2, depth=2, text_dim=64, vec_dim=32,
                         time_embed_dim=64)
    tree = _numpy_vchitect_tree(cfg, np.random.default_rng(51))
    # 3 frames of 12 x 12 patches + 20 context tokens: 164 tokens a frame (K1)
    kw = dict(num_frames=3, height=192, width=192, num_inference_steps=8, txt_len=20,
              use_magcache=True, magcache_thresh=0.3)
    outs = {}
    reset_counts()
    for name, device, dtype in (("card", dev, "bfloat16"), ("cpu", torch.device("cpu"),
                                                            "float32")):
        c = dataclasses.replace(cfg, dtype=dtype)
        model = VchitectModel(c, device)
        model.load_state_dict(vchitect_params_from_numpy(tree, c, device))
        pipe = VchitectPipeline(VchitectPipelineConfig(dtype=dtype, **kw), device, model=model)
        out = pipe.generate("a red boat", seed=4)
        outs[name] = out.latents.float().cpu()
        if name == "card":
            launched = read_counts()
            skips = out.skips
    runs = int((~skips.all(1)).sum())
    if not skips.any() or runs == len(skips):
        fail("narrow Vchitect: no step skipped, or every step did")
    check_narrow("Vchitect", outs["card"], outs["cpu"], launched,
                 {k: n * cfg.depth // 24 * runs for k, n in VCH_TRUNK_LAUNCHES.items()})
    log(f"    Vchitect: {runs} of {len(skips)} steps computed")

    for label, vae, decode, z_shape in (
            ("OSP CausalVAE v1.2 layout, whole", osp_vae, "decode", (1, 3, 4, 5, 4)),
            ("CogVideoX VAE, decode_tiled in slices of 3 + 2", cog_vae, "decode_tiled",
             (1, 5, 4, 6, 16))):
        z = torch.randn(z_shape, generator=torch.Generator().manual_seed(51))
        card = getattr(vae, decode)(z.to(dev)).cpu()
        cpu = type(vae)(vae.cfg, "cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
        want = getattr(cpu, decode)(z)
        err = float((card - want).abs().max() / want.abs().max())
        # f32 convs without TF32 on both sides: summation order only
        log(f"  {label} {tuple(want.shape)}: card vs CPU max |diff| / max |CPU| {err:.3e} "
            f"(tol 1e-4), rel L2 {rel_l2(card, want):.3e}")
        if tuple(card.shape) != tuple(want.shape) or err > 1e-4:
            fail(f"{label}: card and CPU disagree")


# The SD VAE, Open-Sora's temporal VAE and their micro-frame composite:
# per-request launches of Open-Sora's masked-frame blocks at 480p (a pinned
# reference frame: the unfused block, K5 spatial and temporal, K6 twice)
OS_MASKED_LAUNCHES = dict(NO_LAUNCHES, grouped_attention_fused_qkv=56,
                          fused_cross_attention=56)


def timed_decode(label: str, dev, fn, shape) -> torch.Tensor:
    """Runs ``fn()`` once on the card and logs its seconds and peak memory;
    fails unless its pixels are finite and of ``shape``."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    px, ms = timed_once(fn)
    if tuple(px.shape) != shape or not bool(torch.isfinite(px).all()):
        fail(f"{label}: pixels {tuple(px.shape)} not finite or not {shape}")
    log(f"  {label}: {shape} in {ms / 1e3:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, pixel std {float(px.std()):.4f}")
    return px


def phase_sd_vae_decodes(dev):
    """Returns the FLUX, Latte, Vchitect and Open-Sora VAEs."""
    from magcache_tpu_torch.models.vae_sd import FLUX_VAE, SD3_VAE, SD_VAE_FT, SDVAE
    from magcache_tpu_torch.models.vae_temporal import open_sora_vae

    log("phase 52: f32 decodes with random weights at each family's full shape, one call "
        "each: the SD VAE (FLUX.1, sd-vae-ft, SD3 presets; video latents frame by frame in "
        "chunks of 8) and Open-Sora's MicroFrameVAE")
    gen = torch.Generator(device=dev).manual_seed(52)
    vaes = {"flux": SDVAE(FLUX_VAE, dev), "latte": SDVAE(SD_VAE_FT, dev),
            "vchitect": SDVAE(SD3_VAE, dev), "open-sora": open_sora_vae(dev)}
    for name, vae in vaes.items():
        vae.init(gen).requires_grad_(False)
        log(f"  {name} VAE: {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M params")
    flux, latte, vch, osv = (vaes[k] for k in ("flux", "latte", "vchitect", "open-sora"))
    z = torch.randn((1, 128, 128, 16), generator=gen, device=dev)
    whole = timed_decode("FLUX.1 VAE decode 1x128x128x16", dev, lambda: flux.decode(z),
                         (1, 1024, 1024, 3))
    tiled = timed_decode("FLUX.1 VAE decode_tiled (64-latent tiles, overlap 8)", dev,
                         lambda: flux.decode_tiled(z), (1, 1024, 1024, 3))
    log(f"    tiled against whole: rel L2 {rel_l2(tiled, whole):.3e} (the blended seams)")
    del whole, tiled
    z = torch.randn((1, 16, 64, 64, 4), generator=gen, device=dev)
    timed_decode("sd-vae-ft (Latte) decode 16x64x64x4", dev, lambda: latte.decode(z),
                 (1, 16, 512, 512, 3))
    z = torch.randn((1, 40, 60, 96, 16), generator=gen, device=dev)
    timed_decode("SD3 VAE (Vchitect) decode 40x60x96x16", dev, lambda: vch.decode(z),
                 (1, 40, 480, 768, 3))
    # the 480p 9:16 request asks for 480x854; its latent grid is 60x106, so
    # the pixels are 848 wide
    z = torch.randn((1, 15, 60, 106, 4), generator=gen, device=dev)
    timed_decode("Open-Sora MicroFrameVAE decode 15x60x106x4 (3 chunks of 5 latents)", dev,
                  lambda: osv.decode(z), (1, 51, 480, 848, 3))
    del z
    torch.cuda.empty_cache()
    return vaes


def pixel_request(label, pipe, want_skips, lat_shape, px_shape, per_run, extra=None,
                  **kw):
    """One request through ``pipe.generate`` from ``TEXT_PROMPTS[0]`` ending
    in pixels: finite pixels of ``px_shape``, ``text_s`` and ``decode_s``,
    the realized skip bits equal to
    ``want_skips``, latents of ``lat_shape``, and the launches since the
    counts were set to 0 equal to ``per_run`` per trunk run (plus
    ``extra``); returns the launches."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(TEXT_PROMPTS[0], seed=3, **kw)
    launched = read_counts()
    px = out.image if out.video is None else out.video
    if px is None or tuple(px.shape) != px_shape or not bool(torch.isfinite(px).all()):
        fail(f"{label}: pixels {None if px is None else tuple(px.shape)} missing, not "
             f"{px_shape} or not finite")
    if tuple(out.latents.shape) != lat_shape or not bool(torch.isfinite(out.latents).all()):
        fail(f"{label}: latents {tuple(out.latents.shape)} not finite or not {lat_shape}")
    if not np.array_equal(out.skips, want_skips):
        fail(f"{label}: realized skips differ from skip_mask_for")
    if not (out.timings.get("decode_s", 0) > 0 and out.timings.get("text_s", 0) > 0):
        fail(f"{label}: no decode_s or text_s")
    runs = int((~out.skips.all(1)).sum())
    want = {k: n * runs + (extra or {}).get(k, 0) for k, n in per_run.items()}
    if launched != want:
        fail(f"{label}: launches {launched} != {want}")
    log(f"  {label}: {out.timings['total_s']:.3f} s, text encode {out.timings['text_s']:.3f} s, "
        f"VAE decode {out.timings['decode_s']:.3f} s; {runs} of {len(out.skips)} steps computed; pixels {tuple(px.shape)} finite, std "
        f"{float(px.std()):.4f}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launched


def phase_pixel_families(dev, vaes, t5s, clip_l, sd3):
    """Returns the launches by path: ``flux-pixels``, ``latte-pixels``,
    ``vchitect-pixels``, ``open-sora-pixels``. Each request encodes its
    prompt through phase 56's encoders: ``t5s`` (T5-XXL by length), ``clip_l``
    (FLUX's pooled vector), ``sd3`` (Vchitect's stack)."""
    import os

    from magcache_tpu_torch.pipelines.flux import FluxPipeline, FluxPipelineConfig
    from magcache_tpu_torch.pipelines.latte import LattePipeline, LattePipelineConfig
    from magcache_tpu_torch.pipelines.open_sora import (OpenSoraPipeline,
                                                        OpenSoraPipelineConfig)
    from magcache_tpu_torch.pipelines.vchitect import VchitectPipeline, VchitectPipelineConfig

    log("phase 53: requests from the prompt through phase 56's encoders, ending in pixels "
        "through the phase-52 VAEs: flux-dev and Kontext (T5-XXL x 512 + CLIP-L pooled; a "
        "conditioning image encoded by the FLUX.1 VAE) at 1024x1024 x 28 steps, Latte (T5-XXL "
        f"x 120) 512x512 x 16 x {LATTE_STEPS} steps, Vchitect (the SD3 stack, {VCH_SD3_TXT} "
        f"context tokens) {VCH_REQ_FRAMES}x480x768 x {VCH_STEPS} steps, Open-Sora (T5-XXL x "
        f"300) 480p 9:16 x 51 x {OS_STEPS} steps with an image reference encoded by "
        "MicroFrameVAE.encode; all with MagCache")
    paths = {}
    model = make_flux_model(dev)
    head = {"layer_norm_mod": FLUX_STEPS}          # FLUX's head: one K3 a step
    total = dict(NO_LAUNCHES)
    for key, guidance in (("flux-dev", 3.5), ("flux-kontext-dev", 2.5)):
        pipe = FluxPipeline(FluxPipelineConfig(model=key, guidance=guidance, use_magcache=True,
                                               num_inference_steps=FLUX_STEPS), dev,
                            model=model, vae=vaes["flux"], text_encoder=t5s[512],
                            pooled_encoder=clip_l)
        kw = {}
        if "kontext" in key:
            img = np.random.default_rng(53).uniform(size=(1024, 1024, 3)).astype(np.float32)
            kw["cond_latents"], ms = timed_once(lambda: pipe.encode_image(img))
            log(f"  Kontext conditioning image 1024x1024 encoded by the FLUX.1 VAE in "
                f"{ms / 1e3:.3f} s, latents std {float(kw['cond_latents'].std()):.4f}")
        launched = pixel_request(f"{key} with pixels", pipe, pipe.skip_mask_for(),
                                 (1, 4096, 64), (1, 1024, 1024, 3), FLUX_TRUNK_LAUNCHES,
                                 extra=head, **kw)
        total = {k: n + launched[k] for k, n in total.items()}
    paths["flux-pixels"] = total
    del model, pipe
    torch.cuda.empty_cache()

    model = make_latte_model(dev)
    pipe = LattePipeline(LattePipelineConfig(num_sampling_steps=LATTE_STEPS, dtype="bfloat16",
                                             use_magcache=True), dev, model=model,
                         vae=vaes["latte"], text_encoder=t5s[120])
    paths["latte-pixels"] = pixel_request(
        "Latte-1 (flat ratios) with pixels", pipe, pipe.skip_mask_for(), (1, 16, 64, 64, 4),
        (1, 16, 512, 512, 3), LATTE_TRUNK_LAUNCHES["packed"])
    del model, pipe
    torch.cuda.empty_cache()

    model = make_vchitect_model(dev)
    pipe = VchitectPipeline(VchitectPipelineConfig(num_frames=VCH_REQ_FRAMES,
                                                   num_inference_steps=VCH_STEPS,
                                                   txt_len=VCH_SD3_TXT, dtype="bfloat16",
                                                   use_magcache=True),
                            dev, model=model, vae=vaes["vchitect"], text_encoder=sd3.context,
                            pooled_encoder=sd3.pooled)
    paths["vchitect-pixels"] = pixel_request(
        "Vchitect-XL (flat ratios) with pixels", pipe, pipe.skip_mask_for(),
        (1, VCH_REQ_FRAMES, 60, 96, 16), (1, VCH_REQ_FRAMES, 480, 768, 3),
        VCH_TRUNK_LAUNCHES)
    del model, pipe
    torch.cuda.empty_cache()

    model = make_os_model(dev)
    pipe = OpenSoraPipeline(OpenSoraPipelineConfig(
        resolution="480p", aspect_ratio="9:16", num_frames=OS_FRAMES,
        num_sampling_steps=OS_STEPS, dtype="bfloat16", use_magcache=True), dev, model=model,
        vae=vaes["open-sora"], text_encoder=t5s[300])
    # an image reference built in memory (no file, no PIL): one frame at the
    # request's 480x854, in [-1, 1], encoded as references are (to 60x106)
    hw = (pipe.config.height, pipe.config.width)
    img = np.random.default_rng(530).uniform(-1, 1, (1,) + hw + (3,)).astype(np.float32)
    ref, ms = timed_once(lambda: pipe.encode_reference(img))
    log(f"  image reference {hw[0]}x{hw[1]} encoded by MicroFrameVAE.encode in "
        f"{ms / 1e3:.3f} s: latents {ref.shape}, std {float(ref.std()):.4f}")
    if ref.shape != (1,) + pipe.latent_shape[1:] or not np.isfinite(ref).all():
        fail(f"Open-Sora reference latents {ref.shape} not one frame of the request's "
             f"{pipe.latent_shape} or not finite")
    ref_path = os.path.join(_scratch_dir(), "ref_480p_image.npy")
    np.save(ref_path, ref)
    paths["open-sora-pixels"] = pixel_request(
        "Open-Sora 480p x 51, frame 0 pinned to the image reference, with pixels", pipe,
        pipe.skip_mask_for(), (1, 15, 60, 106, 4), (1, OS_FRAMES, 480, 848, 3),
        OS_MASKED_LAUNCHES, ms="0,0,0,0,1,0", refs=ref_path, align=None)
    del model, pipe
    torch.cuda.empty_cache()
    return paths


def phase_vae_card_vs_cpu(dev):
    """The SD VAE, the temporal VAE and the composite at tiny widths, f32
    encode and decode on the card against the CPU."""
    from magcache_tpu_torch.models.vae import MicroFrameVAE
    from magcache_tpu_torch.models.vae_sd import SDVAE, SDVAEConfig
    from magcache_tpu_torch.models.vae_temporal import VAETemporal, VAETemporalConfig

    log("phase 54: the SD VAE, the temporal VAE and MicroFrameVAE at tiny widths, f32 "
        "encode and decode, the card against the CPU (tol 1e-4 of the largest value)")
    scfg = SDVAEConfig(base=8, ch_mult=(1, 1, 2, 2), blocks_per_level=1, groups=4)
    tcfg = VAETemporalConfig(filters=8, num_res_blocks=1, groups=4)

    def make_vaes(device):
        return {"SD VAE": SDVAE(scfg, device), "temporal VAE": VAETemporal(tcfg, device),
                "MicroFrameVAE": MicroFrameVAE(SDVAE(scfg, device), VAETemporal(tcfg, device))}

    g = torch.Generator().manual_seed(54)
    cases = {"SD VAE": (torch.rand((3, 48, 80, 3), generator=g) * 2 - 1,
                        torch.randn((3, 6, 10, 4), generator=g)),
             "temporal VAE": (torch.randn((1, 9, 6, 10, 4), generator=g),
                              torch.randn((1, 3, 6, 10, 4), generator=g)),
             "MicroFrameVAE": (torch.rand((1, 9, 48, 80, 3), generator=g) * 2 - 1,
                               torch.randn((1, 7, 6, 10, 4), generator=g))}
    gen = torch.Generator(device=dev).manual_seed(54)
    card, cpu = make_vaes(dev), make_vaes("cpu")
    for name, (x, z) in cases.items():
        card[name].init(gen)
        cpu[name].load_state_dict({k: v.cpu() for k, v in card[name].state_dict().items()})
        for op, arg in (("encode", x), ("decode", z)):
            want = getattr(cpu[name], op)(arg)
            got = getattr(card[name], op)(arg.to(dev))
            want, got = (w[0] if isinstance(w, tuple) else w for w in (want, got))
            err = float((got.cpu() - want).abs().max() / want.abs().max())
            log(f"  {name} {op} {tuple(arg.shape)} -> {tuple(want.shape)}: card vs CPU "
                f"max |diff| / max |CPU| {err:.3e}")
            if tuple(got.shape) != tuple(want.shape) or err > 1e-4:
                fail(f"{name} {op}: card and CPU disagree")


# ------------------------------------------- the text encoders from the prompt
# A request's prompt and the families' negative one (every ported family
# but Wan defaults to ""), as the requests of phases 50 and 53 encode them
TEXT_PROMPTS = ["A red sailboat glides across a calm bay at dawn.", ""]


def build_encoder(dev, label, build):
    """``build()`` (an encoder with random weights on the card), logged:
    parameters, init seconds, memory allocated."""
    torch.cuda.synchronize(dev)
    t0 = time.time()
    enc = build()
    torch.cuda.synchronize(dev)
    n = sum(p.numel() for p in enc.model.parameters())
    log(f"  {label}: {n / 1e9:.3f} B parameters ({enc.cfg.dtype}), random init "
        f"{time.time() - t0:.2f} s, {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    return enc


def encode_twice(dev, fn):
    """``(fn(), [first s, second s], peak GB)``: two calls, each ending in a
    synchronise, under one peak-memory window."""
    torch.cuda.reset_peak_memory_stats(dev)
    secs = []
    for _ in range(2):
        torch.cuda.synchronize(dev)
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize(dev)
        secs.append(time.time() - t0)
    return out, secs, torch.cuda.max_memory_allocated(dev) / 1e9


def check_t5_encode(dev, label, enc):
    """``TEXT_PROMPTS`` through a T5-family encoder at its length: fails on a
    non-finite or misshapen output, a nonzero row past the prompt or a zero
    row within it."""
    out, secs, peak = encode_twice(dev, lambda: enc(TEXT_PROMPTS))
    mask = torch.from_numpy(enc.tokenizer(TEXT_PROMPTS, max_length=enc.seq_len)[
        "attention_mask"]).to(dev)
    want = (2, enc.seq_len, enc.cfg.d_model)
    if (tuple(out.shape) != want or not bool(torch.isfinite(out).all())
            or bool(out[mask == 0].any()) or not bool(out[mask == 1].any(-1).all())):
        fail(f"{label} x {enc.seq_len}: output {tuple(out.shape)} not {want}, not finite, "
             f"nonzero past the prompt or zero within it")
    log(f"  {label} x {enc.seq_len} tokens: encode {secs[0]:.3f} s (first call), "
        f"{secs[1]:.3f} s (second); output {tuple(out.shape)} {out.dtype}, "
        f"{int(mask.sum())} prompt tokens, std {float(out[mask == 1].std()):.4f}; peak "
        f"{peak:.2f} GB")
    return out


def check_clip_encode(dev, label, enc):
    """``TEXT_PROMPTS`` through a CLIP tower at 77 tokens: fails unless the
    states (``hidden_skip``'s) are finite of ``[2, 77, dim]`` and the pooled
    vector is the normed state at each prompt's EOS (the tokenizer's EOS id,
    49,407), projected when the encoder projects."""
    from magcache_tpu_torch.models.clip import clip_text_forward

    tok = enc.tokenizer(TEXT_PROMPTS, max_length=enc.seq_len)
    ids, mask = (torch.from_numpy(tok[k]).to(dev) for k in ("input_ids", "attention_mask"))
    (h, pooled), secs, peak = encode_twice(dev, lambda: enc.encode_ids(ids, mask))
    normed, _ = clip_text_forward(enc.model, ids, mask)
    eos = (ids == enc.tokenizer.eos).int().argmax(1)
    row = normed[torch.arange(2, device=dev), eos]
    want = row @ enc.model.text_proj.float() if enc.project else row
    cfg = enc.cfg
    if (tuple(h.shape) != (2, enc.seq_len, cfg.dim)
            or tuple(pooled.shape) != tuple(want.shape)
            or not bool(torch.isfinite(h).all()) or not bool(torch.isfinite(pooled).all())
            or float((pooled - want).abs().max()) > 1e-5 * float(want.abs().max())):
        fail(f"{label}: states {tuple(h.shape)} / pooled {tuple(pooled.shape)} misshapen, "
             f"not finite, or pooled away from the EOS row")
    log(f"  {label}: encode {secs[0]:.4f} s (first call), {secs[1]:.4f} s (second); "
        f"states {tuple(h.shape)} (hidden_skip {enc.hidden_skip}), pooled "
        f"{tuple(pooled.shape)}{' projected' if enc.project else ''} at the EOS rows "
        f"{eos.tolist()}, std {float(pooled.std()):.4f}; peak {peak:.2f} GB")


def phase_mt5(dev):
    """mT5-XXL at full width in f32; returns it (phase 50's Open-Sora-Plan
    request encodes through it)."""
    from magcache_tpu_torch.models.t5 import MT5_XXL
    from magcache_tpu_torch.models.text import FallbackHashTokenizer, T5Encoder

    log(f"phase 55: mT5-XXL (Open-Sora-Plan v1.2's encoder) at full width, {MT5_XXL.dtype}: "
        f"a prompt and the negative \"\" x {OSP_CAP} tokens through the hash tokenizer")
    tok = FallbackHashTokenizer(MT5_XXL.vocab_size)
    enc = build_encoder(dev, "mT5-XXL", lambda: T5Encoder(
        MT5_XXL, seq_len=OSP_CAP, tokenizer=tok, device=dev,
        generator=torch.Generator(device=dev).manual_seed(55)))
    check_t5_encode(dev, "mT5-XXL", enc)
    return enc


def phase_text_encoders(dev):
    """T5-XXL, CLIP-L and the SD3 stack at full width in f32. Returns the
    T5-XXL encoders by length, CLIP-L and the stack (phase 53's requests
    encode through them)."""
    from magcache_tpu_torch.models.clip import CLIP_BIGG, CLIP_L, CLIP_L_SD3
    from magcache_tpu_torch.models.t5 import T5_V1_1_XXL
    from magcache_tpu_torch.models.text import (ClipTextEncoder, FallbackHashTokenizer,
                                                Sd3TextStack, T5Encoder)

    log(f"phase 56: T5-XXL at full width ({T5_V1_1_XXL.dtype}) at 512 (FLUX), 300 (Open-Sora), "
        f"226 (CogVideoX) and 120 (Latte) tokens; CLIP-L pooled at 77 (FLUX: legacy EOS, no "
        f"projection); CLIP-L and CLIP-bigG with projection and hidden_skip 1, and the SD3 "
        f"stack at 77 + {SD3_T5_LEN} (Vchitect); each a prompt and the negative \"\"")
    gen = torch.Generator(device=dev).manual_seed(56)
    tok = FallbackHashTokenizer(T5_V1_1_XXL.vocab_size)
    t5 = build_encoder(dev, "T5-XXL", lambda: T5Encoder(T5_V1_1_XXL, tokenizer=tok, device=dev,
                                                      generator=gen))
    t5s = {n: T5Encoder(T5_V1_1_XXL, seq_len=n, tokenizer=tok, model=t5.model)
           for n in (512, 300, 226, 120, SD3_T5_LEN)}
    for n in (512, 300, 226, 120):
        check_t5_encode(dev, "T5-XXL", t5s[n])
    clips = {}
    for name, cfg, kw in (("CLIP-L", CLIP_L, {}),
                          ("CLIP-L (SD3)", CLIP_L_SD3, dict(hidden_skip=1, project=True)),
                          ("CLIP-bigG (SD3)", CLIP_BIGG, dict(hidden_skip=1, project=True))):
        clips[name] = build_encoder(dev, name, lambda: ClipTextEncoder(
            cfg, device=dev, generator=gen, **kw))
        check_clip_encode(dev, name, clips[name])

    def stack():
        return Sd3TextStack(clips["CLIP-L (SD3)"], clips["CLIP-bigG (SD3)"], t5s[SD3_T5_LEN])

    def encode_fresh():             # a new stack a call: no memo between the two
        s = stack()
        return s.context(TEXT_PROMPTS), s.pooled(TEXT_PROMPTS)

    (ctx, pooled), secs, peak = encode_twice(dev, encode_fresh)
    mask = torch.from_numpy(tok(TEXT_PROMPTS, max_length=SD3_T5_LEN)["attention_mask"]).to(dev)
    if (tuple(ctx.shape) != (2, VCH_SD3_TXT, 4096) or tuple(pooled.shape) != (2, 2048)
            or not bool(torch.isfinite(ctx).all()) or not bool(torch.isfinite(pooled).all())
            or bool(ctx[:, :77, 768 + 1280:].any()) or bool(ctx[:, 77:][mask == 0].any())):
        fail(f"SD3 stack: context {tuple(ctx.shape)} / pooled {tuple(pooled.shape)} "
             f"misshapen, not finite, or nonzero in the CLIP channels' pad or past the T5 "
             f"prompt")
    log(f"  SD3 stack (CLIP-L + CLIP-bigG penultimate states zero-padded to 4096, T5-XXL x "
        f"{SD3_T5_LEN}): encode {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second); "
        f"context {tuple(ctx.shape)}, pooled {tuple(pooled.shape)}; peak {peak:.2f} GB")
    return t5s, clips["CLIP-L"], stack()


def phase_text_card_vs_cpu(dev):
    """Narrow T5 (relu and gated, block 0's bias), mT5 and CLIP (quick-gelu
    and gelu, projected) on the card against the CPU in f32."""
    from magcache_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from magcache_tpu_torch.models.t5 import MT5_XXL, T5Config, T5Model
    from magcache_tpu_torch.models.text import ClipTextEncoder, T5Encoder

    log("phase 57: narrow text encoders, f32, the card against the CPU (tol 1e-4 of the "
        "largest value): T5 relu and gated-gelu (block 0's bias), mT5 (its 250,112-token "
        "vocabulary), CLIP quick-gelu (pooled) and gelu (hidden_skip 1), both projected")
    rng = np.random.default_rng(57)
    gen = torch.Generator(device=dev).manual_seed(57)
    narrow = dict(d_model=256, d_kv=64, d_ff=512, layers=3, heads=4)
    mask = np.ones((2, 64), np.int64)
    mask[1, 40:] = 0

    def check(label, got, want):
        got = [g.cpu() for g in got]
        err = max(float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want))
        # f32 without TF32 on both: summation order only
        log(f"  {label}: max |diff| / max |CPU| {err:.3e} (tol 1e-4), rel L2 "
            f"{max(rel_l2(g, w) for g, w in zip(got, want)):.3e}")
        if err > 1e-4 or any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"{label}: the card and the CPU disagree")

    for label, cfg in (("T5 relu", T5Config(vocab_size=1000, feed_forward="relu", **narrow)),
                       ("T5 gated-gelu", T5Config(vocab_size=1000, **narrow)),
                       ("mT5", T5Config(vocab_size=MT5_XXL.vocab_size, **narrow))):
        card = T5Encoder(cfg, device=dev, generator=gen)
        cpu_model = T5Model(cfg, "cpu")
        cpu_model.load_state_dict(card.model.state_dict())
        ids = rng.integers(2, cfg.vocab_size, (2, 64))
        check(f"{label} (d 256, 3 layers)", [card.encode_ids(ids, mask)],
              [T5Encoder(cfg, model=cpu_model).encode_ids(ids, mask)])
    for label, quick, skip in (("CLIP quick-gelu, pooled", True, 0),
                               ("CLIP gelu, hidden_skip 1", False, 1)):
        cfg = CLIPTextConfig(dim=256, heads=4, layers=3, quick_gelu=quick, projection_dim=128)
        card = ClipTextEncoder(cfg, hidden_skip=skip, project=True, device=dev, generator=gen)
        cpu_model = CLIPTextModel(cfg, "cpu")
        cpu_model.load_state_dict(card.model.state_dict())
        cpu = ClipTextEncoder(cfg, hidden_skip=skip, project=True, model=cpu_model)
        tok = card.tokenizer(["a photo of a cat on a mat", "Two anthropomorphic cats fight "
                              "on a stage while the crowd cheers"], max_length=77)
        ids, attn = tok["input_ids"], tok["attention_mask"]
        check(f"{label} (d 256, 3 layers, projection 128)", card.encode_ids(ids, attn),
              cpu.encode_ids(ids, attn))


# ------------------------------------------ Wan2.1 I2V-14B and FLF2V-14B
# Launches per trunk run of the 14B i2v trunk (40 blocks): K1 three times a
# block (self, text cross, image cross), K2 twice (q, k), K3 three times (two
# mod, one affine); the head adds K3p once a step. The CLIP tower adds one
# K1 launch (running max) per block it runs, 31 an image.
I2V_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=120, rms_norm_rope=80,
                          layer_norm_mod=120)
I2V_GRID, I2V_REQ_FRAMES = (21, 30, 52), 17
# the JAX CLI's i2v and flf2v defaults are 40 and 50 steps; cut to 20 each
# (PR 24) to keep the smoke inside its limit
I2V_STEPS, FLF_STEPS = 20, 20
CLIP_BLOCKS_RUN = 31                  # ViT-H/14's 32 blocks less the last
# bf16 keeps 8 significant bits: a rounding moves a value by at most 2^-9 of
# it. The tower's K1 call rounds q, k, v, p and its output: five roundings
BF16_TOWER_TOL = 5 * 2 ** -9
# the whole tower: each block's rounded attention adds its error to the
# residual stream; at most one bf16 step (2^-9) of it a block, 31 blocks
CLIP_TOWER_TOL = CLIP_BLOCKS_RUN * 2 ** -9


def i2v_launches(runs: int, steps: int, images: int) -> dict:
    """Launches of an i2v (``images`` 1) or flf2v (2) request: the trunk's
    per run, K3p once a step, and the tower's K1 launches per image."""
    out = {k: n * runs for k, n in I2V_TRUNK_LAUNCHES.items()}
    out["layer_norm_mod_plain"] += steps
    out["flash_attention_bshd"] += CLIP_BLOCKS_RUN * images
    return out


def phase_i2v_kernels(dev, rec):
    """K1, K2, K3 and K3p against their plain versions at the I2V-14B shapes,
    and K1 at the CLIP tower's."""
    from magcache_tpu_torch.models.wan import WAN_14B, wan_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    log("phase 58: kernels vs plain at Wan2.1 I2V-14B 832x480x81 shapes (bf16): K1 self "
        "2x32760x40x128 (fixed max), cross to 512 text, 257 image (i2v) and 514 image "
        "(flf2v) keys, the CLIP tower's 1x257x16x80 (running max, q/k/v rounded to bf16, "
        "80 padded to 128); K2 at 40 heads; K3 mod, affine and K3p at width 5,120")
    gen = torch.Generator(device=dev).manual_seed(5858)
    B, S, H, D = 2, math.prod(I2V_GRID), WAN_14B.heads, WAN_14B.head_dim
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    torch.cuda.reset_peak_memory_stats(dev)
    # q and k of std sqrt(3), as qk-normed rows with gains near sqrt(3): the
    # logits have std 3 (their largest, about 7 std, stays near fixed_max 16),
    # so each row's softmax sits on a few keys and a dropped or doubled key
    # tile moves the output by about its own size, far past the tolerance
    qk = 3 ** 0.5
    q, k, v = rnd(B, S, H, D, scale=qk), rnd(B, S, H, D, scale=qk), rnd(B, S, H, D)
    cases = [("self, fixed_max=16", k, v)]
    for n, what in ((512, "text"), (257, "image, i2v"), (514, "image, flf2v")):
        cases.append((f"cross {n} keys ({what}), fixed_max=16", rnd(B, n, H, D, scale=qk),
                      rnd(B, n, H, D)))
    for label, kk, vv in cases:
        got = A.flash_attention_bshd(q, kk, vv, fixed_max=16.0)
        want, pms = timed_once(lambda: A.flash_attention_bshd_plain(q, kk, vv, fixed_max=16.0))
        # kernel and plain round at the same points, but the f32 logits differ
        # in summation order, so a dominant weight's bf16 rounding may flip:
        # one step (2^-8) of it moves an output by up to 2^-8 max|v|
        atol = 2 ** -8 * float(vv.abs().max())
        err = compare(f"K1 flash_attention_bshd [I2V-14B {label}]", got, want, atol=atol,
                      rtol=2e-2)
        rms = float(want.float().pow(2).mean().sqrt())
        log(f"  the plain output's RMS {rms:.3e}: max_abs_err is {err / rms:.3e} of it")
        del got, want
        ms = cuda_ms(lambda: A.flash_attention_bshd(q, kk, vv, fixed_max=16.0), 3)
        lms = sdpa_ms(q, kk, vv, 3)
        flops = 4 * B * H * S * kk.shape[1] * D
        moved = 2 * nbytes(q) + nbytes(kk, vv)
        log(f"  K1 [I2V-14B {label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), plain "
            f"{pms:.3f} ms (one call), SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop",
             f"2x{S}x40x128 I2V-14B {label}", (flops, moved),
             ("F.scaled_dot_product_attention", lms))
    del q, k, v, cases
    torch.cuda.empty_cache()

    # the CLIP tower's self-attention as the f32 tower calls it on the card
    qf, kf, vf = (rnd(1, 257, 16, 80, dtype=torch.float32) for _ in range(3))
    k1_check(rec, "K1 [CLIP ViT-H/14 tower 1x257x16x80]", "CLIP tower 1x257x16x80 running "
             "max, bf16-rounded f32 operands", *(t.to(bf) for t in (qf, kf, vf)), None)
    got = A.attention(*(t.to(bf) for t in (qf, kf, vf))).float()
    want = A.flash_attention_bshd_plain(qf, kf, vf)
    err = float((got - want).abs().max() / want.abs().max())
    log(f"  the tower's rounding: K1 on bf16-rounded q/k/v against the plain f32 attention: "
        f"max |diff| / max |f32| {err:.3e} (tol {BF16_TOWER_TOL:.3e}: five bf16 roundings), "
        f"rel L2 {rel_l2(got, want):.3e}")
    if err > BF16_TOWER_TOL:
        fail("the CLIP tower's bf16 K1 call strays from the f32 attention")

    x = rnd(B, S, H * D, scale=2.0)
    gain = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    cos_np, sin_np = wan_rope_tables(WAN_14B, I2V_GRID)
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    got = P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6)
    # a flipped bf16 rounding of the normed value: one ulp at |y| < 8
    err = compare("K2 rms_norm_rope [token scope, 40 heads]", got, want, atol=3e-2,
                  rtol=1.6e-2)
    del got, want
    ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6))
    pms = cuda_ms(lambda: P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6), 3)
    log(f"  K2 [40 heads]: kernel {ms:.3f} ms ({2 * nbytes(x) / ms / 1e6:.0f} GB/s), plain "
        f"{pms:.3f} ms")
    keep(rec, "rms_norm_rope", err, ms, pms, "loop", f"2x{S}x5120 (40 heads)",
         elementwise_work(x, gain, cos, sin))
    sc = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    sh = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    w = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    bias = rnd(H * D, dtype=torch.float32, scale=0.1)
    for label, kw, name in (("mod", dict(scale=sc, shift=sh), "layer_norm_mod"),
                            ("affine", dict(weight=w, bias=bias), "layer_norm_mod"),
                            ("plain (K3p)", {}, "layer_norm_mod_plain")):
        got = P.layer_norm_mod(x, eps=1e-6, **kw)
        want = P.layer_norm_mod_plain(x, eps=1e-6, **kw)
        err = compare(f"K3 layer_norm_mod [{label}, width 5120]", got, want, atol=3e-2,
                      rtol=1.6e-2)
        del got, want
        ms = cuda_ms(lambda: P.layer_norm_mod(x, eps=1e-6, **kw))
        pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, eps=1e-6, **kw), 3)
        lib = None
        if label != "mod":          # one library call computes these two forms
            wb, bb = ((w.to(bf), bias.to(bf)) if kw else (None, None))
            lib = ("F.layer_norm" + ("" if kw else " (no affine)"), cuda_ms(
                lambda: torch.nn.functional.layer_norm(x, (H * D,), wb, bb, eps=1e-6)))
        log(f"  K3 [{label}, width 5120]: kernel {ms:.3f} ms "
            f"({2 * nbytes(x) / ms / 1e6:.0f} GB/s), plain {pms:.3f} ms"
            + (f", {lib[0]} {lib[1]:.3f} ms" if lib else ""))
        keep(rec, name, err, ms, pms, "loop", f"2x{S}x5120 {label}",
             elementwise_work(x, *kw.values()), lib)
    log(f"  peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")


def make_i2v_model(dev, task="i2v"):
    """The I2V-14B trunk as ``WanPipelineConfig`` builds it (WAN_14B, 36
    input channels, the CLIP branch; bf16), random weights drawn on the
    card."""
    from magcache_tpu_torch.models.wan import WanModel
    from magcache_tpu_torch.pipelines.wan import WanPipelineConfig

    cfg = WanPipelineConfig(model="wan2.1-i2v-480p", task=task).model_config()
    torch.cuda.synchronize(dev)
    t0 = time.time()
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    model.requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  I2V-14B ({task}) bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    return model


def phase_i2v_forward(dev, model):
    """Returns the launches of the two forwards."""
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.models.wan import make_wan_core

    cfg = model.cfg
    f, h, w = I2V_GRID
    log(f"phase 59: one full-shape I2V-14B forward (prepare -> trunk -> head), 832x480x81: "
        f"{f * h * w} tokens, 2 lanes, {cfg.clip_tokens} + {cfg.text_len} context tokens")
    core = make_wan_core(model, I2V_GRID)
    gen = torch.Generator(device=dev).manual_seed(59)
    x = torch.randn((2, f, 2 * h, 2 * w, 16), generator=gen, device=dev)
    cond = {"context": MockTextEncoder(512, 4096, scale=0.5)(["a cat", ""], device=dev),
            "y": torch.randn((2, f, 2 * h, 2 * w, 20), generator=gen, device=dev),
            "clip_fea": torch.randn((2, cfg.clip_tokens, cfg.clip_dim), generator=gen,
                                    device=dev)}
    t = torch.full((2,), 900.0, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    for run in ("first", "second"):
        def forward():
            hidden, c = core.prepare(x, t, cond)
            return core.head(core.trunk(hidden, c), c), c
        (out, c), ms = timed_once(forward)
        log(f"  forward ({run} call): {ms / 1e3:.3f} s")
    counts = read_counts()
    if tuple(c["context"].shape) != (2, cfg.clip_tokens + 512, cfg.dim):
        fail(f"I2V-14B joint context {tuple(c['context'].shape)}")
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        fail(f"I2V-14B forward output {tuple(out.shape)} is not finite or misshapen")
    want = i2v_launches(2, 2, 0)
    if counts != want:
        fail(f"I2V-14B forwards: launches {counts} != {want}")
    log(f"  output {tuple(out.shape)} finite, std {float(out.std()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches per forward "
        f"K1 {counts['flash_attention_bshd'] // 2}, K2 {counts['rms_norm_rope'] // 2}, "
        f"K3 {counts['layer_norm_mod'] // 2}, K3p {counts['layer_norm_mod_plain'] // 2}")
    return counts


def i2v_images(n: int, seed: int = 60):
    """``n`` seeded uint8 images of 720x1280 (resized to 480x832 and to the
    tower's 224x224 by the pipeline)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (720, 1280, 3), dtype=np.uint8) for _ in range(n)]


def i2v_encoders(dev):
    """UMT5-XXL (f32, the hash tokenizer), the CLIP ViT-H/14 tower (f32) and
    the Wan2.1 VAE (f32), random weights drawn on the card."""
    from magcache_tpu_torch.models.clip import CLIP_VIT_H, CLIPVisionModel
    from magcache_tpu_torch.models.text import FallbackHashTokenizer
    from magcache_tpu_torch.models.umt5 import UMT5_XXL, UMT5Encoder
    from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE

    gen = torch.Generator(device=dev).manual_seed(60)
    t0 = time.time()
    text = UMT5Encoder(UMT5_XXL, seq_len=512, tokenizer=FallbackHashTokenizer(
        UMT5_XXL.vocab_size), device=dev, generator=gen)
    clip = CLIPVisionModel(CLIP_VIT_H, dev).init(gen).requires_grad_(False)
    vae = WanVAE(WAN21_VAE, dev).init(gen).requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  UMT5-XXL {sum(p.numel() for p in text.model.parameters()) / 1e9:.3f} B, CLIP "
        f"ViT-H/14 {sum(p.numel() for p in clip.parameters()) / 1e9:.3f} B, Wan2.1 VAE "
        f"{sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M params (f32): random init "
        f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    return text, clip, vae


def i2v_request(label, pipe, want_skips, images):
    """One i2v (one image) or flf2v (two) request through ``pipe.generate``
    ending in pixels [1, frames, 480, 832, 3]: fails unless pixels and
    latents are finite and of their shapes, ``text_s``, ``image_s`` and
    ``decode_s`` are there, the realized skip bits are ``want_skips`` and the
    launches are ``i2v_launches`` of the trunk runs; returns the launches."""
    n, steps = pipe.config.frame_num, pipe.config.sample_steps
    kw = dict(image=images[0]) if len(images) == 1 else dict(image=images[0],
                                                             last_image=images[1])
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(TEXT_PROMPTS[0], seed=3, **kw)
    launched = read_counts()
    video, lat = out.video, out.latents
    if video is None or tuple(video.shape) != (1, n, 480, 832, 3) or not bool(
            torch.isfinite(video).all()):
        fail(f"{label}: pixels {None if video is None else tuple(video.shape)} missing, "
             f"misshapen or not finite")
    if tuple(lat.shape) != (1, (n - 1) // 4 + 1, 60, 104, 16) or not bool(
            torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or misshapen")
    if not np.array_equal(out.skips, want_skips):
        fail(f"{label}: realized skips differ from compute_skip_schedule")
    t = out.timings
    if not all(t.get(k, 0) > 0 for k in ("text_s", "image_s", "decode_s")):
        fail(f"{label}: timings {t} lack text_s, image_s or decode_s")
    runs = int((~out.skips.all(1)).sum())
    want = i2v_launches(runs, steps, len(images))
    if launched != want:
        fail(f"{label}: launches {launched} != {want} ({runs} trunk runs)")
    log(f"  {label}: {t['total_s']:.3f} s/video (text {t['text_s']:.3f} s, image encode "
        f"{t['image_s']:.3f} s, VAE decode {t['decode_s']:.3f} s); {int(out.skips.sum())} of "
        f"{out.skips.size} lane-forwards skipped, {runs} of {steps} steps computed "
        f"({int((out.skips.sum(1) == 1).sum())} half-batch); pixels {tuple(video.shape)} "
        f"finite, std {float(video.std()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launched, lat


def phase_i2v_requests(dev, model, text, clip, vae):
    """Returns the launches of the two requests."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 60: i2v requests through WanPipeline.generate(image=) at full width, "
        f"832x480x{I2V_REQ_FRAMES} (7,800 tokens), {I2V_STEPS} UniPC steps, shift 3.0, CFG "
        f"5.0: UMT5-XXL text, a seeded 720x1280 image through the CLIP ViT-H/14 tower and "
        f"the Wan2.1 VAE encode, the f32 VAE decode; full compute, then MagCache "
        f"wan2.1-i2v-480p (E012K4R02)")
    base = dict(model="wan2.1-i2v-480p", task="i2v", size=(832, 480),
                frame_num=I2V_REQ_FRAMES, sample_steps=I2V_STEPS, sample_shift=3.0,
                guide_scale=5.0)
    kw = dict(model=model, text_encoder=text, clip=clip, vae=vae)
    full = WanPipeline(WanPipelineConfig(**base), dev, **kw)
    cached = WanPipeline(WanPipelineConfig(use_magcache=True, **base), dev, **kw)
    sched = compute_skip_schedule(cached._cache_cfg()).reshape(I2V_STEPS, 2)
    if int(sched.sum()) != 22:
        fail(f"wan2.1-i2v-480p at {I2V_STEPS} steps elides {int(sched.sum())} of "
             f"{2 * I2V_STEPS}, not 22")
    total = dict(NO_LAUNCHES)
    lats = {}
    image = i2v_images(1)
    for label, pipe, want in (("i2v full compute", full, np.zeros((I2V_STEPS, 1), bool)),
                              ("i2v MagCache wan2.1-i2v-480p", cached, sched)):
        launched, lats[label] = i2v_request(label, pipe, want, image)
        total = {k: n + launched[k] for k, n in total.items()}
    log(f"  MagCache latents against full compute: rel L2 "
        f"{rel_l2(*lats.values()):.3e}")
    tower_rounding(dev, clip, image[0])
    return total


def tower_rounding(dev, clip, image):
    """The ViT-H/14 tower's features of ``image`` as the pipeline makes them
    (K1 on bf16-rounded q, k, v in each of the 31 blocks) against the same
    tower with the plain attention in f32 on the card: fails past a rel L2
    of ``CLIP_TOWER_TOL``."""
    from unittest import mock

    from magcache_tpu_torch.models import clip as C
    from magcache_tpu_torch.ops import attention as A

    px = C.preprocess_clip_image(image, clip.cfg)
    got = C.clip_vision_forward(clip, px)
    with mock.patch.object(C, "_tower_attention", A.flash_attention_bshd_plain):
        want = C.clip_vision_forward(clip, px)
    rel = rel_l2(got, want)
    worst = float((got - want).abs().max() / want.abs().max())
    log(f"  the CLIP ViT-H/14 tower ({CLIP_BLOCKS_RUN} blocks, f32) with K1 on bf16-rounded "
        f"q/k/v against the plain f32 attention: features {tuple(got.shape)}, rel L2 "
        f"{rel:.3e} (tol {CLIP_TOWER_TOL:.3e}), max |diff| / max |f32| {worst:.3e}")
    if not bool(torch.isfinite(got).all()) or rel > CLIP_TOWER_TOL:
        fail("the CLIP tower's features with the bf16 K1 call stray from the f32 tower's")


def phase_flf2v_request(dev, text, clip, vae):
    """Returns the request's launches."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.models.vae import CausalVAE, CausalVAEConfig
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 61: a flf2v request at 832x480x{I2V_REQ_FRAMES}, {FLF_STEPS} UniPC steps, "
        f"shift 16, MagCache wan2.1-i2v-480p (514 CLIP tokens: two images through the "
        f"tower); then the CausalVAE fallback encode of [image; 16 zero frames] at "
        f"832x480x{I2V_REQ_FRAMES}")
    log("phase 61 model:")
    model = make_i2v_model(dev, "flf2v")
    pipe = WanPipeline(WanPipelineConfig(
        model="wan2.1-i2v-480p", task="flf2v", size=(832, 480), frame_num=I2V_REQ_FRAMES,
        sample_steps=FLF_STEPS, sample_shift=16.0, guide_scale=5.0, use_magcache=True),
        dev, model=model, text_encoder=text, clip=clip, vae=vae)
    sched = compute_skip_schedule(pipe._cache_cfg()).reshape(FLF_STEPS, 2)
    if int(sched.sum()) != 22:
        fail(f"wan2.1-i2v-480p at {FLF_STEPS} steps elides {int(sched.sum())} of "
             f"{2 * FLF_STEPS}, not 22")
    launched, _ = i2v_request("flf2v MagCache wan2.1-i2v-480p", pipe, sched, i2v_images(2))
    del model, pipe
    torch.cuda.empty_cache()

    # the fallback encoder the pipeline builds without a VAE (the CLI's path)
    fallback = CausalVAE(CausalVAEConfig(), dev).init(
        torch.Generator(device=dev).manual_seed(11)).requires_grad_(False)
    px = torch.zeros((1, I2V_REQ_FRAMES, 480, 832, 3), device=dev)
    px[:, 0] = torch.rand((480, 832, 3), generator=torch.Generator(device=dev).manual_seed(61),
                          device=dev) * 2 - 1
    torch.cuda.reset_peak_memory_stats(dev)
    (mean, logvar), ms = timed_once(lambda: fallback.encode(px))
    want = (1, (I2V_REQ_FRAMES - 1) // 4 + 1, 60, 104, 16)
    if tuple(mean.shape) != want or not bool(torch.isfinite(mean).all() & torch.isfinite(
            logvar).all()):
        fail(f"CausalVAE encode: latents {tuple(mean.shape)} not {want} or not finite")
    log(f"  CausalVAE (base 96, {sum(p.numel() for p in fallback.parameters()) / 1e6:.1f} M "
        f"params, f32) encode of {tuple(px.shape)} in one pass: {ms / 1e3:.3f} s, latents "
        f"{tuple(mean.shape)} finite, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return launched


def _numpy_wan_i2v_tree(cfg, rng):
    """``_numpy_wan_tree`` with the i2v entries: ``img_emb`` and the image
    cross-attention's k/v projections and k norm."""
    d, L = cfg.dim, cfg.layers
    tree = _numpy_wan_tree(cfg, rng)

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    tree["img_emb"] = {"in": lin(cfg.clip_dim, cfg.clip_dim), "out": lin(cfg.clip_dim, d)}
    tree["blocks"].update(cross_k_img=lin(d, d, L), cross_v_img=lin(d, d, L),
                          cross_norm_k_img=1.0 + 0.1 * rng.standard_normal((L, d)))
    return tree


def _numpy_clip_vision_tree(cfg, rng):
    """A random CLIP vision tree in the JAX package's layout."""
    d, L = cfg.dim, cfg.layers

    def lin(d_in, d_out):
        return {"w": rng.standard_normal((L, d_in, d_out)) / math.sqrt(d_in),
                "b": rng.standard_normal((L, d_out)) * 0.02}

    def norm(*shape):
        return 1.0 + 0.1 * rng.standard_normal(shape), 0.1 * rng.standard_normal(shape)

    n1, n2, pre, post = norm(L, d), norm(L, d), norm(d), norm(d)
    return {"patch_embed": {"w": rng.standard_normal((3 * cfg.patch ** 2, d)) / cfg.patch,
                            "b": np.zeros(d)},
            "cls": rng.standard_normal(d) * 0.02,
            "pos": rng.standard_normal((cfg.tokens, d)) * 0.02,
            "pre_norm_w": pre[0], "pre_norm_b": pre[1],
            "post_norm_w": post[0], "post_norm_b": post[1],
            "blocks": {"norm1_w": n1[0], "norm1_b": n1[1], "norm2_w": n2[0],
                       "norm2_b": n2[1], "qkv": lin(d, 3 * d), "proj": lin(d, d),
                       "mlp1": lin(d, 4 * d), "mlp2": lin(4 * d, d)}}


NARROW_I2V = dict(dim=256, heads=2, ffn_dim=512, layers=NARROW_LAYERS, model_type="i2v",
                  in_channels=36, clip_dim=160, clip_tokens=257)


def narrow_i2v_pipeline(device, dtype, task):
    """The narrow i2v / flf2v pipeline (2 blocks of 2 heads of 128, a
    2-block CLIP tower of 2 heads of 80 at 224 px, a Wan-stride VAE of base
    16) with numpy weights from one seed, at 192x128 x 9 frames (288
    tokens: K1 in the DiT and, at 257 tokens, in the tower)."""
    from magcache_tpu_torch.models.clip import CLIPVisionConfig, CLIPVisionModel
    from magcache_tpu_torch.models.convert import (clip_vision_params_from_numpy,
                                                   wan_params_from_numpy)
    from magcache_tpu_torch.models.vae_wan import WanVAE, WanVAEConfig
    from magcache_tpu_torch.models.wan import WanConfig, WanModel
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    rng = np.random.default_rng(62)
    kw = dict(NARROW_I2V, clip_tokens=257 * (2 if task == "flf2v" else 1))
    cfg = WanConfig.tiny(dtype=str(dtype).split(".")[1], **kw)
    model = WanModel(cfg, device)
    model.load_state_dict(wan_params_from_numpy(_numpy_wan_i2v_tree(cfg, rng), cfg, device))
    ccfg = CLIPVisionConfig(dim=160, layers=2, heads=2)
    clip = CLIPVisionModel(ccfg, device)
    clip.load_state_dict(clip_vision_params_from_numpy(_numpy_clip_vision_tree(ccfg, rng), ccfg,
                                                       device))
    vae = WanVAE(WanVAEConfig(base=16, num_res_blocks=1), "cpu").init(
        torch.Generator().manual_seed(62)).to(device)
    return WanPipeline(WanPipelineConfig(
        model="wan2.1-i2v-480p", task=task, size=(192, 128), frame_num=9,
        sample_steps=len(NARROW_MASK), sample_shift=3.0, guide_scale=5.0, use_magcache=True,
        model_cfg_override=cfg), device, model=model.requires_grad_(False),
        clip=clip.requires_grad_(False), vae=vae.requires_grad_(False))


def phase_i2v_card_vs_cpu(dev):
    """The narrow i2v and flf2v pipelines, tower and VAE encoder included,
    bf16 DiT on the card against f32 on the CPU."""
    from magcache_tpu_torch.models.clip import clip_vision_forward, preprocess_clip_image

    log("phase 62: narrow i2v and flf2v pipelines (the CLIP tower and the Wan VAE encode "
        "included) on the card (kernels, bf16 DiT, f32 tower and VAE) against the CPU "
        "(plain ops, f32), over UniPC steps with skipped ones")
    images = [np.random.default_rng(62 + i).integers(0, 256, (100, 180, 3), dtype=np.uint8)
              for i in range(2)]
    for task, imgs in (("i2v", images[:1]), ("flf2v", images)):
        card = narrow_i2v_pipeline(dev, torch.bfloat16, task)
        cpu = narrow_i2v_pipeline(torch.device("cpu"), torch.float32, task)
        kw = dict(image=imgs[0], last_image=imgs[1] if task == "flf2v" else None)
        reset_counts()
        got = card.generate("a red boat at dawn", seed=2, skip_override=NARROW_MASK, **kw)
        launched = read_counts()
        want = cpu.generate("a red boat at dawn", seed=2, skip_override=NARROW_MASK, **kw)
        runs = int((~NARROW_MASK.all(1)).sum())
        per_run = {k: n * NARROW_LAYERS // 40 for k, n in I2V_TRUNK_LAUNCHES.items()}
        expected = {k: n * runs for k, n in per_run.items()}
        expected["layer_norm_mod_plain"] += len(NARROW_MASK)
        expected["flash_attention_bshd"] += (card.clip.cfg.layers - 1) * len(imgs)
        check_narrow(f"narrow {task}", got.latents.float().cpu(), want.latents, launched,
                     expected)
        # the f32 tower with its bf16 K1 call, and the f32 VAE encode
        pre = preprocess_clip_image(imgs[0], card.clip.cfg)
        fg = clip_vision_forward(card.clip, pre).cpu()
        fw = clip_vision_forward(cpu.clip, pre)
        err = float((fg - fw).abs().max() / fw.abs().max())
        log(f"  {task} CLIP tower (2 heads of 80, 257 tokens) card vs CPU: max |diff| / max "
            f"|CPU| {err:.3e} (tol {BF16_TOWER_TOL:.3e}: K1's five bf16 roundings), rel L2 "
            f"{rel_l2(fg, fw):.3e}")
        if err > BF16_TOWER_TOL:
            fail(f"{task}: the CLIP tower on the card strays from the CPU's")
        yg, _ = card.encode_flf(*imgs) if task == "flf2v" else card.encode_image(imgs[0])
        yw, _ = cpu.encode_flf(*imgs) if task == "flf2v" else cpu.encode_image(imgs[0])
        err = float((yg.cpu() - yw).abs().max() / yw.abs().max())
        log(f"  {task} conditioning latents y (Wan VAE encode, f32) card vs CPU: max |diff| / "
            f"max |CPU| {err:.3e} (tol 1e-4: f32 convs without TF32, summation order)")
        if err > 1e-4 or not torch.equal(yg[..., :4].cpu(), yw[..., :4]):
            fail(f"{task}: the conditioning latents on the card stray from the CPU's")
        del card, cpu



# ---------------------------- Wan2.2 TI2V-5B, Wan2.1 VACE and the A14B MoE
# Launches per trunk run of a Wan trunk of ``blocks`` blocks (the VACE
# stack's blocks count as blocks): K1 twice a block (self, text cross), K2
# twice (q, k), K3 twice with the modulation and once affine; with the
# per-token timestep (ti2v with an image) each modulated call is two: every
# row, then the t = 0 prefix. The head adds K3p once a step.
TI2V_GRID = (31, 22, 40)        # 1280x704x121: latents (31, 44, 80), patch (1, 2, 2)
TI2V_SIZE, TI2V_STEPS = (1280, 704), 50
VACE_STEPS = 50                 # the JAX CLI's default
A14B_STEPS = 24                 # cut from the JAX CLI's 40; lane-asymmetric steps remain
WAN22_FRAMES = 17                # the requests' frames, cut from 81 and 121


def wan_trunk_launches(blocks: int, t0_prefix: bool = False) -> dict:
    """A Wan trunk run's launches: with the per-token timestep's t = 0
    prefix, each modulated LayerNorm is two K3 calls (every row, then the
    prefix)."""
    return dict(NO_LAUNCHES, flash_attention_bshd=2 * blocks, rms_norm_rope=2 * blocks,
                layer_norm_mod=(4 if t0_prefix else 2) * blocks + blocks)


def wan_run_launches(per_run: dict, runs: int, steps: int) -> dict:
    """Launches of a Wan request or forwards: ``per_run`` a trunk run, K3p
    once a step."""
    out = {k: n * runs for k, n in per_run.items()}
    out["layer_norm_mod_plain"] += steps
    return out


def peak(dev) -> str:
    return f"peak memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"


def phase_wan22_kernels(dev, rec):
    """K1, K2, K3 and K3p against their plain versions at the TI2V-5B
    shapes (24 heads, width 3,072), K3 also on the t = 0 prefix's copy."""
    from magcache_tpu_torch.models.wan import WAN_5B, wan_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    B, S, H, D = 2, math.prod(TI2V_GRID), WAN_5B.heads, WAN_5B.head_dim
    n0 = TI2V_GRID[1] * TI2V_GRID[2]
    log(f"phase 63: kernels vs plain at Wan2.2 TI2V-5B 1280x704x121 shapes (bf16): K1 self "
        f"2x{S}x24x128 (fixed max) and cross to 512 text keys; K2 at 24 heads; K3 mod, "
        f"affine and K3p at width 3,072, K3 mod on the t = 0 prefix's contiguous copy "
        f"(2x{n0} rows)")
    gen = torch.Generator(device=dev).manual_seed(6363)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    torch.cuda.reset_peak_memory_stats(dev)
    qk = 3 ** 0.5                    # peaked softmax rows, as phase 58
    q, k, v = rnd(B, S, H, D, scale=qk), rnd(B, S, H, D, scale=qk), rnd(B, S, H, D)
    for label, kk, vv in (("self, fixed_max=16", k, v),
                          ("cross 512 keys (text), fixed_max=16", rnd(B, 512, H, D, scale=qk),
                           rnd(B, 512, H, D))):
        got = A.flash_attention_bshd(q, kk, vv, fixed_max=16.0)
        want, pms = timed_once(lambda: A.flash_attention_bshd_plain(q, kk, vv, fixed_max=16.0))
        # one flipped bf16 rounding of a dominant weight (phase 58)
        err = compare(f"K1 flash_attention_bshd [TI2V-5B {label}]", got, want,
                      atol=2 ** -8 * float(vv.abs().max()), rtol=2e-2)
        del got, want
        ms = cuda_ms(lambda: A.flash_attention_bshd(q, kk, vv, fixed_max=16.0), 3)
        lms = sdpa_ms(q, kk, vv, 3)
        flops = 4 * B * H * S * kk.shape[1] * D
        moved = 2 * nbytes(q) + nbytes(kk, vv)
        log(f"  K1 [TI2V-5B {label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), plain "
            f"{pms:.3f} ms (one call), SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop",
             f"2x{S}x24x128 TI2V-5B {label}", (flops, moved),
             ("F.scaled_dot_product_attention", lms))
    del q, k, v
    torch.cuda.empty_cache()

    x = rnd(B, S, H * D, scale=2.0)
    gain = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    cos_np, sin_np = wan_rope_tables(WAN_5B, TI2V_GRID)
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    got = P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6)
    want = P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6)
    # a flipped bf16 rounding of the normed value: one ulp at |y| < 8
    err = compare("K2 rms_norm_rope [token scope, 24 heads: BLOCK_H 32]", got, want,
                  atol=3e-2, rtol=1.6e-2)
    del got, want
    ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6))
    pms = cuda_ms(lambda: P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6), 3)
    log(f"  K2 [24 heads]: kernel {ms:.3f} ms ({2 * nbytes(x) / ms / 1e6:.0f} GB/s), plain "
        f"{pms:.3f} ms")
    keep(rec, "rms_norm_rope", err, ms, pms, "loop", f"2x{S}x3072 (24 heads)",
         elementwise_work(x, gain, cos, sin))
    sc, sh, sc0, sh0 = (rnd(B, 1, H * D, dtype=torch.float32, scale=0.1) for _ in range(4))
    w = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    bias = rnd(H * D, dtype=torch.float32, scale=0.1)
    seg0 = x[:, :n0].contiguous()
    for label, xx, kw, name in (
            ("mod", x, dict(scale=sc, shift=sh), "layer_norm_mod"),
            ("affine", x, dict(weight=w, bias=bias), "layer_norm_mod"),
            ("plain (K3p)", x, {}, "layer_norm_mod_plain"),
            (f"mod, t = 0 prefix 2x{n0}", seg0, dict(scale=sc0, shift=sh0), "layer_norm_mod")):
        got = P.layer_norm_mod(xx, eps=1e-6, **kw)
        want = P.layer_norm_mod_plain(xx, eps=1e-6, **kw)
        err = compare(f"K3 layer_norm_mod [{label}, width 3072: BLOCK 4096]", got, want,
                      atol=3e-2, rtol=1.6e-2)
        del got, want
        ms = cuda_ms(lambda: P.layer_norm_mod(xx, eps=1e-6, **kw))
        pms = cuda_ms(lambda: P.layer_norm_mod_plain(xx, eps=1e-6, **kw), 3)
        lib = None
        if not label.startswith("mod"):     # one library call computes these forms
            wb, bb = ((w.to(bf), bias.to(bf)) if kw else (None, None))
            lib = ("F.layer_norm" + ("" if kw else " (no affine)"), cuda_ms(
                lambda: torch.nn.functional.layer_norm(xx, (H * D,), wb, bb, eps=1e-6)))
        log(f"  K3 [{label}]: kernel {ms:.3f} ms ({2 * nbytes(xx) / ms / 1e6:.0f} GB/s), "
            f"plain {pms:.3f} ms" + (f", {lib[0]} {lib[1]:.3f} ms" if lib else ""))
        keep(rec, name, err, ms, pms, "loop", f"2x{xx.shape[1]}x3072 {label}",
             elementwise_work(xx, *kw.values()), lib)

    # the block's call with the t = 0 prefix as a whole (K3 over every row,
    # the prefix's copy, K3 on it, written over the first rows) against one
    # K3 over every row: the prefix's cost
    def with_prefix():
        out = P.layer_norm_mod(x, scale=sc, shift=sh)
        out[:, :n0] = P.layer_norm_mod(x[:, :n0].contiguous(), scale=sc0, shift=sh0)
        return out

    want = P.layer_norm_mod_plain(x, scale=sc, shift=sh)
    want[:, :n0] = P.layer_norm_mod_plain(seg0, scale=sc0, shift=sh0)
    compare("K3 call with the t = 0 prefix [whole K3 + prefix copy, K3, write]", with_prefix(),
            want, atol=3e-2, rtol=1.6e-2)
    seg_ms = cuda_ms(with_prefix)
    whole_ms = cuda_ms(lambda: P.layer_norm_mod(x, scale=sc, shift=sh))
    copy_ms = cuda_ms(lambda: x[:, :n0].contiguous())
    log(f"  the K3 call with the t = 0 prefix: {seg_ms:.3f} ms against one whole K3 "
        f"{whole_ms:.3f} ms (the prefix copy alone {copy_ms:.3f} ms); 60 such calls a "
        f"forward cost {60 * (seg_ms - whole_ms):.1f} ms more than whole K3 calls")
    log(f"  {peak(dev)}")


def make_wan_model(dev, cfg, label, seed=0):
    """``WanModel(cfg)`` with random weights drawn on the card."""
    from magcache_tpu_torch.models.wan import WanModel

    torch.cuda.synchronize(dev)
    t0 = time.time()
    model = WanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(seed))
    model.requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  {label} bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    return model


def wan_forward(dev, label, model, grid, x, cond, runs, want):
    """``runs`` forwards (prepare -> trunk -> head) on two lanes, timed;
    fails unless the output is finite and of x's shape and the launches are
    ``want``; returns them."""
    from magcache_tpu_torch.models.wan import make_wan_core

    core = make_wan_core(model, grid)
    t = torch.full((2,), 900.0, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    for run in range(runs):
        def forward():
            hidden, c = core.prepare(x, t, cond)
            return core.head(core.trunk(hidden, c), c)
        out, ms = timed_once(forward)
        log(f"  {label} forward (call {run + 1}): {ms / 1e3:.3f} s")
    counts = read_counts()
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        fail(f"{label} forward output {tuple(out.shape)} is not finite or misshapen")
    if counts != want:
        fail(f"{label} forwards: launches {counts} != {want}")
    log(f"  {label}: output {tuple(out.shape)} finite, std {float(out.std()):.4f}; {peak(dev)}; "
        f"launches per forward K1 {counts['flash_attention_bshd'] // runs}, K2 "
        f"{counts['rms_norm_rope'] // runs}, K3 {counts['layer_norm_mod'] // runs}, K3p "
        f"{counts['layer_norm_mod_plain'] // runs}")
    return counts


def phase_ti2v_forward(dev, model):
    """Returns the launches of the two forwards."""
    from magcache_tpu_torch.models.text import MockTextEncoder

    f, h, w = TI2V_GRID
    log(f"phase 64: two full-shape TI2V-5B forwards (prepare -> trunk -> head) at "
        f"1280x704x121 with an image's t = 0 prefix: {f * h * w} tokens ({h * w} at t = 0), "
        f"2 lanes, 512 text tokens")
    gen = torch.Generator(device=dev).manual_seed(64)
    x = torch.randn((2, f, 2 * h, 2 * w, 48), generator=gen, device=dev)
    cond = {"context": MockTextEncoder(512, 4096, scale=0.5)(["a cat", ""], device=dev),
            "ti2v_img": x[:1, :1]}
    return wan_forward(dev, "TI2V-5B", model, TI2V_GRID, x, cond, 2,
                       wan_run_launches(wan_trunk_launches(30, True), 2, 2))


def phase_vace14_forward(dev):
    """Returns the forward's launches."""
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.pipelines.wan import WanPipelineConfig

    f, h, w = I2V_GRID
    log(f"phase 66: one full-shape VACE-14B forward at 832x480x81: {f * h * w} "
        f"tokens, 2 lanes, 40 blocks and 8 VACE blocks over the 96-channel context")
    model = make_wan_model(dev, WanPipelineConfig(model="wan2.1-vace-14B",
                                                  task="vace").model_config(), "VACE-14B")
    gen = torch.Generator(device=dev).manual_seed(65)
    x = torch.randn((2, f, 2 * h, 2 * w, 16), generator=gen, device=dev)
    cond = {"context": MockTextEncoder(512, 4096, scale=0.5)(["a cat", ""], device=dev),
            "vace_context": torch.randn((2, f, 2 * h, 2 * w, 96), generator=gen, device=dev)}
    counts = wan_forward(dev, "VACE-14B", model, I2V_GRID, x, cond, 1,
                         wan_run_launches(wan_trunk_launches(48), 1, 1))
    del model
    torch.cuda.empty_cache()
    return counts


def wan22_request(label, pipe, want_skips, lat_shape, px_shape, per_run, **kw):
    """One request through ``pipe.generate`` ending in pixels: fails unless
    pixels and latents are finite and of their shapes, ``text_s``,
    ``decode_s`` (and with an encode ``image_s``) are there, the realized
    skip bits are ``want_skips`` and the launches are ``per_run`` a trunk run
    plus K3p once a step; returns the output and launches."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(TEXT_PROMPTS[0], seed=3, **kw)
    launched = read_counts()
    video, lat = out.video, out.latents
    if video is None or tuple(video.shape) != px_shape or not bool(torch.isfinite(video).all()):
        fail(f"{label}: pixels {None if video is None else tuple(video.shape)} missing, not "
             f"{px_shape} or not finite")
    if tuple(lat.shape) != lat_shape or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or not {lat_shape}")
    if not np.array_equal(out.skips, want_skips):
        fail(f"{label}: realized skips differ from compute_skip_schedule")
    t = out.timings
    need = ("text_s", "decode_s") + (("image_s",) if kw else ())
    if not all(t.get(k, 0) > 0 for k in need):
        fail(f"{label}: timings {t} lack one of {need}")
    steps = len(out.skips)
    runs = int((~out.skips.all(1)).sum())
    want = wan_run_launches(per_run, runs, steps)
    if launched != want:
        fail(f"{label}: launches {launched} != {want} ({runs} trunk runs)")
    encode = f"image or video encode {t['image_s']:.3f} s, " if "image_s" in t else ""
    log(f"  {label}: {t['total_s']:.3f} s/video (text {t['text_s']:.3f} s, {encode}VAE "
        f"decode {t['decode_s']:.3f} s); "
        f"{int(out.skips.sum())} of {out.skips.size} lane-forwards skipped, {runs} of {steps} "
        f"steps computed ({int((out.skips.sum(1) == 1).sum())} half-batch); pixels "
        f"{tuple(video.shape)} finite, std {float(video.std()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out, launched


def check_elided(pipe, steps, elided):
    from magcache_tpu_torch.core.magcache import compute_skip_schedule

    sched = compute_skip_schedule(pipe._cache_cfg()).reshape(steps, 2)
    if int(sched.sum()) != elided:
        fail(f"{pipe.config.model} at {steps} steps elides {int(sched.sum())} of "
             f"{2 * steps}, not {elided}")
    return sched


def vace_sources(frames, h, w, seed=65):
    """A seeded source video [F, H, W, 3] in [0, 1] and a mask [F, H, W]: 1
    inside a box over the middle of each frame, 0 elsewhere."""
    rng = np.random.default_rng(seed)
    video = rng.random((frames, h, w, 3), dtype=np.float32)
    mask = np.zeros((frames, h, w), np.float32)
    mask[:, h // 4:3 * h // 4, w // 4:3 * w // 4] = 1.0
    return video, mask


def phase_vace_requests(dev, vae):
    """VACE-1.3B requests; returns their launches."""
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 67: requests through WanPipeline.generate at full width, "
        f"832x480x{WAN22_FRAMES}: VACE-1.3B (30 blocks, 6 VACE blocks) with MagCache "
        f"wan2.1-vace-1.3B at {VACE_STEPS} steps, shift 16, from a seeded source video and "
        f"box mask through the Wan VAE encode (f32) and decode; then an R2V request with one "
        f"reference image (a prepended latent frame, trimmed)")
    base = dict(model="wan2.1-vace-1.3B", task="vace", size=(832, 480),
                frame_num=WAN22_FRAMES, sample_steps=VACE_STEPS, sample_shift=16.0,
                guide_scale=5.0, use_magcache=True)
    pipe = WanPipeline(WanPipelineConfig(**base), dev, vae=vae)
    log(f"  VACE-1.3B: {sum(p.numel() for p in pipe.model.parameters()) / 1e9:.3f} B params")
    sched = check_elided(pipe, VACE_STEPS, 50)
    video, mask = vace_sources(WAN22_FRAMES, 480, 832)
    lat, px = (1, 5, 60, 104, 16), (1, WAN22_FRAMES, 480, 832, 3)
    per_run = wan_trunk_launches(36)
    _, total = wan22_request("VACE-1.3B MagCache", pipe, sched, lat, px, per_run,
                             src_video=video, src_mask=mask)
    r2v = WanPipeline(WanPipelineConfig(vace_ref_images=1, **base), dev, model=pipe.model,
                      vae=vae)
    ref = np.random.default_rng(66).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    _, launched = wan22_request("VACE-1.3B R2V MagCache (6 latent frames sampled, 5 kept)",
                                r2v, sched, lat, px, per_run, src_video=video, src_mask=mask,
                                src_ref_images=[ref])
    del pipe, r2v
    torch.cuda.empty_cache()
    return {k: n + launched[k] for k, n in total.items()}


def phase_ti2v_request(dev, model):
    """Returns the request's launches."""
    from magcache_tpu_torch.models.vae_wan import WAN22_VAE, WanVAE
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    w, h = TI2V_SIZE
    log(f"phase 65: a TI2V-5B request through WanPipeline.generate(image=) at "
        f"{w}x{h}x{WAN22_FRAMES} (4,400 tokens), MagCache wan2.2-ti2v-5B-i2v at "
        f"{TI2V_STEPS} steps, shift 5: the seeded image through the Wan2.2 VAE encode (f32, base 160, 48 channels, patchify 2) "
        f"as latent frame 0 at t = 0, the Wan2.2 VAE decode")
    vae = WanVAE(WAN22_VAE, dev).init(torch.Generator(device=dev).manual_seed(67))
    vae.requires_grad_(False)
    log(f"  Wan2.2 VAE: {sum(p.numel() for p in vae.parameters()) / 1e6:.1f} M params (f32)")
    pipe = WanPipeline(WanPipelineConfig(
        model="wan2.2-ti2v-5B-i2v", task="ti2v", size=TI2V_SIZE, frame_num=WAN22_FRAMES,
        sample_steps=TI2V_STEPS, sample_shift=5.0, guide_scale=5.0, use_magcache=True),
        dev, model=model, vae=vae)
    sched = check_elided(pipe, TI2V_STEPS, 48)
    image = np.random.default_rng(68).integers(0, 256, (720, 1280, 3), dtype=np.uint8)
    out, launched = wan22_request(
        "TI2V-5B MagCache, image", pipe, sched, (1, 5, h // 16, w // 16, 48),
        (1, WAN22_FRAMES, h, w, 3), wan_trunk_launches(30, True), image=image)
    frame0 = pipe.encode_ti2v(image)
    err = float((out.latents[:, :1] - frame0).abs().max())
    log(f"  latent frame 0 against the image's encode: max |diff| {err:.3e} (tol 1e-5 of "
        f"its largest value {float(frame0.abs().max()):.3e})")
    if err > 1e-5 * float(frame0.abs().max()):
        fail("TI2V-5B: latent frame 0 is not the image latents after sampling")
    del pipe, vae
    torch.cuda.empty_cache()
    return launched


def phase_a14b_requests(dev, vae):
    """t2v-A14B and i2v-A14B requests with both experts resident; returns
    their launches."""
    from magcache_tpu_torch.core.sampler import DiTCore
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    log(f"phase 68: Wan2.2 A14B MoE requests through WanPipeline.generate at "
        f"832x480x{WAN22_FRAMES}, {A14B_STEPS} UniPC steps, two WAN_14B experts resident "
        f"(the mock text encoder: UMT5-XXL in f32 does not fit beside them); t2v-A14B shift 12, CFG (3.0, 4.0), "
        f"MagCache wan2.2-t2v-A14B; i2v-A14B shift 5, CFG (3.5, 3.5), MagCache "
        f"wan2.2-i2v-A14B, from a seeded image through the Wan VAE encode")
    total = dict(NO_LAUNCHES)
    for task, shift, guide, elided, boundary in (("t2v", 12.0, (3.0, 4.0), 17, 16),
                                                 ("i2v", 5.0, (3.5, 3.5), 13, 9)):
        model = f"wan2.2-{task}-A14B"
        cfg = WanPipelineConfig(model=model, task=task, size=(832, 480),
                                frame_num=WAN22_FRAMES, sample_steps=A14B_STEPS,
                                sample_shift=shift, guide_scale=guide, use_magcache=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        high = make_wan_model(dev, cfg.model_config(), f"{model} high-noise expert")
        low = make_wan_model(dev, cfg.model_config(), f"{model} low-noise expert", seed=1)
        pipe = WanPipeline(cfg, dev, model=high, model_low=low, vae=vae)
        b = pipe.boundary_step()
        log(f"  {model}: boundary step {b} (the high-noise expert runs steps 0-{b - 1}), "
            f"split_step {pipe._cache_cfg().split_step}")
        if b != boundary:
            fail(f"{model}: boundary step {b}, not {boundary}")
        sched = check_elided(pipe, A14B_STEPS, elided)
        calls = {"high": 0, "low": 0}

        def spy(core, name):
            def trunk(hidden, ctx):
                calls[name] += 1
                return core.trunk(hidden, ctx)
            return DiTCore(core.prepare, trunk, core.head)

        pipe.core, pipe.core_low = spy(pipe.core, "high"), spy(pipe.core_low, "low")
        kw = {}
        if task == "i2v":
            kw["image"] = np.random.default_rng(69).integers(0, 256, (720, 1280, 3),
                                                             dtype=np.uint8)
        out, launched = wan22_request(
            f"{model} MagCache", pipe, sched, (1, 5, 60, 104, 16),
            (1, WAN22_FRAMES, 480, 832, 3), wan_trunk_launches(40), **kw)
        runs = ~out.skips.all(1)
        want = {"high": int(runs[:b].sum()), "low": int(runs[b:].sum())}
        log(f"  {model}: trunk runs by expert {calls} (the computed steps before and after "
            f"the switch: {want}); two experts resident, {peak(dev)}")
        if calls != want:
            fail(f"{model}: the experts ran {calls}, not {want}")
        total = {k: n + launched[k] for k, n in total.items()}
        del pipe, high, low, out
        torch.cuda.empty_cache()
    return total


def _numpy_wan_vace_tree(cfg, rng):
    """``_numpy_wan_tree`` with the VACE subtree (JAX layout)."""
    from magcache_tpu_torch.models.wan import VACE_IN_CHANNELS

    d, Lv = cfg.dim, len(cfg.vace_layers)
    tree = _numpy_wan_tree(cfg, rng)
    vblocks = _numpy_wan_tree(dataclasses.replace(cfg, layers=Lv), rng)["blocks"]

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    tree["vace"] = {"patch_embedding": lin(VACE_IN_CHANNELS * 4, d),
                    "before_proj": lin(d, d), "after_proj": lin(d, d, Lv), "blocks": vblocks}
    return tree


NARROW = dict(dim=256, heads=2, ffn_dim=512, layers=NARROW_LAYERS)


def narrow_wan22_pipeline(device, dtype, kind):
    """The narrow VACE (two VACE blocks), ti2v (48 channels, a Wan2.2-layout
    VAE of base 16) or t2v-A14B (two experts) pipeline, numpy weights from
    one seed, 288 tokens a lane."""
    from magcache_tpu_torch.models.convert import wan_params_from_numpy
    from magcache_tpu_torch.models.vae_wan import WanVAE, WanVAEConfig
    from magcache_tpu_torch.models.wan import WanConfig, WanModel
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    rng = np.random.default_rng(66)
    dt = str(dtype).split(".")[1]
    kw = dict(vace_layers=(0, 1)) if kind == "vace" else (
        dict(in_channels=48, out_channels=48) if kind == "ti2v" else {})
    cfg = WanConfig.tiny(dtype=dt, **NARROW, **kw)

    def model(tree):
        m = WanModel(cfg, device)
        m.load_state_dict(wan_params_from_numpy(tree, cfg, device))
        return m.requires_grad_(False)

    vae_kw = dict(z_channels=48, patchify=2) if kind == "ti2v" else {}
    vae = WanVAE(WanVAEConfig(base=16, num_res_blocks=1, **vae_kw), "cpu").init(
        torch.Generator().manual_seed(66)).to(device).requires_grad_(False)
    base = dict(frame_num=9, model_cfg_override=cfg, guide_scale=5.0)
    if kind == "vace":
        pc = WanPipelineConfig(model="wan2.1-vace-1.3B", task="vace", size=(192, 128),
                               sample_steps=len(NARROW_MASK), sample_shift=16.0, **base)
        return WanPipeline(pc, device, model=model(_numpy_wan_vace_tree(cfg, rng)), vae=vae)
    if kind == "ti2v":
        pc = WanPipelineConfig(model="wan2.2-ti2v-5B-i2v", task="ti2v", size=(384, 256),
                               sample_steps=len(NARROW_MASK), sample_shift=5.0, **base)
        return WanPipeline(pc, device, model=model(_numpy_wan_tree(cfg, rng)), vae=vae)
    pc = WanPipelineConfig(model="wan2.2-t2v-A14B", size=(192, 128), sample_steps=8,
                           sample_shift=5.0, use_magcache=True,
                           **dict(base, guide_scale=(3.0, 4.0)))
    return WanPipeline(pc, device, model=model(_numpy_wan_tree(cfg, rng)),
                       model_low=model(_numpy_wan_tree(cfg, rng)), vae=vae)


def phase_wan22_card_vs_cpu(dev):
    """The narrow VACE, ti2v and A14B pipelines, bf16 DiT on the card against
    f32 on the CPU."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule

    log("phase 69: narrow VACE (a source video and mask), ti2v (an image through a "
        "Wan2.2-layout VAE) and A14B (two experts, MagCache across the switch) pipelines on "
        "the card (kernels, bf16 DiT, f32 VAE) against the CPU (plain ops, f32)")
    rng = np.random.default_rng(66)
    video, mask = vace_sources(9, 128, 192, seed=66)
    image = rng.integers(0, 256, (100, 180, 3), dtype=np.uint8)
    cases = (("vace", dict(src_video=video, src_mask=mask, skip_override=NARROW_MASK), 4, False),
             ("ti2v", dict(image=image, skip_override=NARROW_MASK), 2, True),
             ("t2v-A14B", {}, 2, False))
    for kind, kw, blocks, t0_prefix in cases:
        card = narrow_wan22_pipeline(dev, torch.bfloat16, kind)
        cpu = narrow_wan22_pipeline(torch.device("cpu"), torch.float32, kind)
        reset_counts()
        got = card.generate("a red boat at dawn", seed=2, **kw)
        launched = read_counts()
        want = cpu.generate("a red boat at dawn", seed=2, **kw)
        if kind == "t2v-A14B":
            sched = compute_skip_schedule(card._cache_cfg()).reshape(8, 2)
            if not np.array_equal(got.skips, sched) or not sched.any():
                fail(f"narrow {kind}: skips {got.skips.tolist()} not the schedule or none")
        runs = int((~got.skips.all(1)).sum())
        per_run = wan_trunk_launches(blocks, t0_prefix)
        check_narrow(f"narrow {kind}", got.latents.float().cpu(), want.latents, launched,
                     wan_run_launches(per_run, runs, len(got.skips)))
        if kind == "ti2v":
            enc_g, enc_w = card.encode_ti2v(image).cpu(), cpu.encode_ti2v(image)
            err = float((enc_g - enc_w).abs().max() / enc_w.abs().max())
            log(f"  ti2v image latents (Wan2.2-layout VAE encode, f32) card vs CPU: max |diff| "
                f"/ max |CPU| {err:.3e} (tol 1e-4: f32 convs without TF32)")
            if err > 1e-4 or not torch.equal(got.latents[:, :1].cpu(), enc_g):
                fail("ti2v: the image latents on the card stray from the CPU's, or frame 0 "
                     "is not them")
        del card, cpu

# ------------------------------------------------ HunyuanVideo and FramePack
# HunyuanVideo T2V at 720x1280x129: 33 latent frames of 45 x 80 tokens after
# the (1, 2, 2) patch, 256 text tokens. Per trunk run of the MMDiT's 20
# double and 40 single blocks: K1 (fixed max) once a block, K2 in head scope
# four times a double block (q, k of each stream) and twice a single one, K3
# four times a double block and once a single one. Every step's prepare adds
# the token refiner's two K1 launches (running max over the 256 text
# tokens) and its head one K3, skipped or not.
HY_GRID, HY_TXT = (33, 45, 80), 256
HY_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=60, rms_norm_rope_head=160,
                         layer_norm_mod=120)
HY_STEP_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=2, layer_norm_mod=1)
HY_REQ_FRAMES, HY_STEPS = 17, 20     # 5 latent frames: 18,000 video tokens; steps cut from 50
HY_ELIDED = 13                       # hunyuanvideo-720p's skips at HY_STEPS
# FramePack at 768x512: sections of 9 latent frames of 32 x 48 tokens behind
# 2 clean frames, one 2x frame (16 x 24) and four 4x frames (8 x 12): 17,664
# image tokens, 17,920 with the text
FP_SIZE, FP_WINDOW, FP_STEPS, FP_SECTIONS = (768, 512), 9, 10, 2   # steps cut from 25
FP_ELIDED = 5                        # framepack's and framepack-f1's skips at FP_STEPS
# the refiner's f32 stream with K1 on bf16-rounded q, k, v: one bf16
# rounding (2^-9) a block, as the CLIP tower's CLIP_TOWER_TOL
REFINER_TOL = 2 * 2 ** -9


def hy_launches(runs: int, steps: int) -> dict:
    """Launches of HunyuanVideo / FramePack forwards: ``runs`` trunk runs,
    ``steps`` prepares and heads."""
    return {k: HY_TRUNK_LAUNCHES[k] * runs + HY_STEP_LAUNCHES[k] * steps for k in NO_LAUNCHES}


def check_hy_launches(label: str, launched: dict, runs: int, steps: int) -> None:
    """Fails unless the launches and K1's by softmax shift (fixed: the
    MMDiT's, running: the refiner's) are those of ``runs`` trunk runs and
    ``steps`` steps."""
    want = hy_launches(runs, steps)
    modes = k1_modes()
    want_modes = {"fixed": 60 * runs, "running": 2 * steps}
    if launched != want or modes != want_modes:
        fail(f"{label}: launches {launched} (K1 {modes}) != {want} (K1 {want_modes}) for "
             f"{runs} trunk runs and {steps} steps")


def phase_hunyuan_kernels(dev, rec):
    """K2h over the 3-D and FramePack tables, K1 at the joint sequences of
    720x1280x129 and of a FramePack section and the refiner's 256 tokens, and
    K3 mod at 118,800 rows, each against its plain version."""
    from magcache_tpu_torch.models.hunyuan import (HUNYUAN_VIDEO, framepack_rope_tables,
                                                   hunyuan_rope_tables)
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    H, D, d, L = 24, 128, 3072, HY_TXT
    n_img = math.prod(HY_GRID)
    fp_grid = (FP_WINDOW, FP_SIZE[1] // 16, FP_SIZE[0] // 16)
    log(f"phase 70: kernels vs plain at HunyuanVideo 720x1280x129 shapes (bf16, {n_img} video "
        f"+ {L} text tokens) and a FramePack section's: K2 head scope over the 3-D tables, K1 "
        f"joint (fixed max), the refiner's K1 (running max over {L} tokens), K3 mod")
    gen = torch.Generator(device=dev).manual_seed(70)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def tables(np_pair):
        return tuple(torch.from_numpy(a).to(dev) for a in np_pair)

    cos, sin = tables(hunyuan_rope_tables(HUNYUAN_VIDEO, L, HY_GRID))
    fcos, fsin = tables(framepack_rope_tables(HUNYUAN_VIDEO, L, fp_grid, 1))
    n_fp = fcos.shape[0] - L
    gain = 1.0 + rnd(D, dtype=torch.float32, scale=0.1)
    # K2 head scope on column slices of the fused projections, read in place
    # (phase 11's tolerance)
    for label, rows, width, col, tabs in (
            (f"image q, 1x{n_img} rows of 9216, 3-D tables", n_img, 3 * d, 0, (cos[L:], sin[L:])),
            (f"text k, 1x{L} rows of 9216", L, 3 * d, d, (cos[:L], sin[:L])),
            (f"single-block q, 1x{L + n_img} rows of 21504", L + n_img, 7 * d, 0, (cos, sin)),
            (f"FramePack image q, 1x{n_fp} rows of 9216, pad 1 tables", n_fp, 3 * d, 0,
             (fcos[L:], fsin[L:]))):
        x = rnd(1, rows, width, scale=2.0)[..., col:col + d]
        kw = dict(eps=1e-6, norm_scope="head")
        got = P.rms_norm_rope(x, gain, *tabs, H, **kw)
        want = P.rms_norm_rope_plain(x, gain, *tabs, H, **kw)
        err = compare(f"K2 rms_norm_rope [head scope, {label}]", got, want,
                      atol=3e-2, rtol=1.6e-2)
        ms = cuda_graph_ms(lambda: P.rms_norm_rope(x, gain, *tabs, H, **kw))
        pms = cuda_graph_ms(lambda: P.rms_norm_rope_plain(x, gain, *tabs, H, **kw))
        log(f"  K2h [{label}]: kernel {ms:.4f} ms ({2 * rows * d * 2 / ms / 1e6:.0f} GB/s), "
            f"plain {pms:.4f} ms")
        keep(rec, "rms_norm_rope_head", err, ms, pms, "graph", label,
             elementwise_work(got, gain, *tabs))
        del x, got, want
    torch.cuda.empty_cache()

    # K1 over the joint [txt; img] sequences with the static shift
    for label, S, reps in ((f"joint 1x{L + n_img}x24x128 (720x1280x129)", L + n_img, 3),
                           (f"FramePack section 1x{L + n_fp}x24x128 (768x512)", L + n_fp, 10)):
        q, k, v = rnd(1, S, H, D), rnd(1, S, H, D), rnd(1, S, H, D)
        got = A.flash_attention_bshd(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
        want, pms = timed_once(lambda: A.flash_attention_bshd_plain(
            q, k, v, fixed_max=A.QKNORM_FIXED_MAX))
        err = compare(f"K1 flash_attention_bshd [{label}, fixed_max=16]", got, want,
                      atol=2e-3, rtol=2e-2)
        del want
        ms = cuda_ms(lambda: A.flash_attention_bshd(q, k, v, fixed_max=16.0), reps)
        lms = sdpa_ms(q, k, v, reps)
        flops = 4 * H * S * S * D
        log(f"  K1 [{label}]: kernel {ms:.3f} ms ({rate(flops, 4 * nbytes(q), ms)}), plain "
            f"{pms:.3f} ms (one call), SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop", label,
             (flops, 4 * nbytes(q)), ("F.scaled_dot_product_attention", lms))
        del q, k, v, got
        torch.cuda.empty_cache()

    # the token refiner's self-attention: its f32 q, k, v rounded to bf16,
    # the running max (its scores are not norm-bounded)
    label = f"refiner 1x{L}x24x128, running max"
    q, k, v = rnd(1, L, H, D), rnd(1, L, H, D), rnd(1, L, H, D)
    got = A.flash_attention_bshd(q, k, v)
    want = A.flash_attention_bshd_plain(q, k, v)
    err = compare(f"K1 flash_attention_bshd [{label}]", got, want, atol=2e-3, rtol=2e-2)
    # a loop, as the CLIP tower's call (phase 58): K1 launches on the
    # library's own stream, which a CUDA graph capture does not record
    ms = cuda_ms(lambda: A.flash_attention_bshd(q, k, v))
    pms = cuda_ms(lambda: A.flash_attention_bshd_plain(q, k, v))
    lms = sdpa_ms(q, k, v, 20)
    flops = 4 * H * L * L * D
    log(f"  K1 [{label}]: kernel {ms:.4f} ms ({rate(flops, 4 * nbytes(q), ms)}), plain "
        f"{pms:.4f} ms, SDPA {lms:.4f} ms")
    keep(rec, "flash_attention_bshd", err, ms, pms, "loop", label, (flops, 4 * nbytes(q)),
         ("F.scaled_dot_product_attention", lms))

    # K3 mod at the double block's image stream
    x = rnd(1, n_img, d, scale=2.0)
    sc, sh = rnd(1, 1, d, dtype=torch.float32, scale=0.3), rnd(1, 1, d, dtype=torch.float32,
                                                                scale=0.3)
    label = f"mod 1x{n_img}x3072"
    got = P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6)
    want = P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6)
    err = compare(f"K3 layer_norm_mod [{label}]", got, want, atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6))
    pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6), 5)
    # at batch 1 the modulation is one row: F.layer_norm with weight 1 + scale
    # and bias shift computes the same function
    wb, bb = (1.0 + sc).view(-1).to(x.dtype), sh.view(-1).to(x.dtype)
    lms = cuda_ms(lambda: torch.nn.functional.layer_norm(x, (d,), wb, bb, eps=1e-6))
    log(f"  K3 [{label}]: kernel {ms:.4f} ms ({2 * x.numel() * 2 / ms / 1e6:.0f} GB/s), "
        f"plain {pms:.4f} ms, F.layer_norm {lms:.4f} ms")
    keep(rec, "layer_norm_mod", err, ms, pms, "loop", label, elementwise_work(x, sc, sh),
         ("F.layer_norm", lms))
    del x, got, want
    torch.cuda.empty_cache()


def make_hunyuan_model(dev):
    """HunyuanVideo's 12.8 B MMDiT with FramePack's clean-latent projections,
    bf16, random weights drawn on the card (one model for every phase)."""
    from magcache_tpu_torch.models.hunyuan import HUNYUAN_VIDEO, HunyuanModel

    cfg = dataclasses.replace(HUNYUAN_VIDEO, dtype="bfloat16", framepack=True)
    torch.cuda.synchronize(dev)
    t0 = time.time()
    model = HunyuanModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(71))
    model.requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  HunyuanVideo bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    return model


def phase_hunyuan_forward(dev, model):
    """Returns the forward's launches."""
    from magcache_tpu_torch.models.hunyuan import make_hunyuan_core
    from magcache_tpu_torch.models.text import MockPooledEncoder, MockTextEncoder

    f, h, w = HY_GRID
    log(f"phase 71: one full-shape HunyuanVideo forward (prepare -> trunk -> head) at "
        f"720x1280x129: {f * h * w} video + {HY_TXT} text tokens in one joint attention, 20 "
        f"double + 40 single blocks")
    core = make_hunyuan_core(model, HY_TXT, HY_GRID)
    gen = torch.Generator(device=dev).manual_seed(71)
    x = torch.randn((1, f, 2 * h, 2 * w, 16), generator=gen, device=dev)
    cond = {"txt": MockTextEncoder(HY_TXT, 4096, scale=0.5)([TEXT_PROMPTS[0]], device=dev),
            "vec": MockPooledEncoder(768)([TEXT_PROMPTS[0]], device=dev),
            "guidance": torch.full((1,), 6.0, device=dev)}
    t = torch.full((1,), 900.0, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()

    def forward():
        hidden, c = core.prepare(x, t, cond)
        return core.head(core.trunk(hidden, c), c)

    out, ms = timed_once(forward)
    launched = read_counts()
    if tuple(out.shape) != tuple(x.shape) or not bool(torch.isfinite(out).all()):
        fail(f"HunyuanVideo forward output {tuple(out.shape)} is not finite or misshapen")
    check_hy_launches("HunyuanVideo forward", launched, 1, 1)
    log(f"  HunyuanVideo forward: {ms / 1e3:.3f} s; output {tuple(out.shape)} finite, std "
        f"{float(out.std()):.4f}; {peak(dev)}; launches K1 {launched['flash_attention_bshd']} "
        f"({k1_modes()}), K2h {launched['rms_norm_rope_head']}, K3 "
        f"{launched['layer_norm_mod']}")
    return launched


def hy_request(label, pipe, sched, want_shape, **kw):
    """One request through ``pipe.generate``: fails unless the latents are
    finite of ``want_shape``, every section's skip bits are ``sched``,
    ``on_section`` ran once a section, ``text_s`` is there and the launches
    are those of the computed steps; returns the output and launches."""
    seen = []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(TEXT_PROMPTS[0], seed=3, on_section=lambda i, lat: seen.append(i),
                        **kw)
    launched = read_counts()
    lat, c = out.latents, pipe.config
    if tuple(lat.shape) != want_shape or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or not {want_shape}")
    if sched is not None and not all(np.array_equal(s[:, 0], sched) for s in out.skips):
        fail(f"{label}: realized skips {out.skips[..., 0].tolist()} differ from the schedule")
    if seen != list(range(c.total_sections)) or not out.timings.get("text_s", 0) > 0:
        fail(f"{label}: on_section saw {seen}, timings {out.timings}")
    runs = int((~out.skips).sum())
    check_hy_launches(label, launched, runs, out.skips.size)
    t = out.timings
    log(f"  {label}: {t['total_s']:.3f} s ({t['total_s'] / c.total_sections:.3f} s a "
        f"section; text {t['text_s']:.3f} s); {int(out.skips.sum())} of {out.skips.size} "
        f"forwards elided, skipped steps by section "
        f"{[np.flatnonzero(s[:, 0]).tolist() for s in out.skips]}; latents "
        f"{tuple(lat.shape)} finite, std {float(lat.std()):.4f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out, launched


def phase_hunyuan_request(dev, model):
    """Returns the request's launches."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.models.clip import CLIP_L
    from magcache_tpu_torch.models.llama import LLAVA_LLAMA3_8B
    from magcache_tpu_torch.models.text import (HYVIDEO_PROMPT_TEMPLATE, ClipTextEncoder,
                                                LlamaTextEncoder)
    from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                        FramePackPipelineConfig)

    window = (HY_REQ_FRAMES - 1) // 4 + 1
    log(f"phase 72: a HunyuanVideo request from the prompt through FramePackPipeline.generate "
        f"at 720x1280x{HY_REQ_FRAMES} ({window * 45 * 80} video tokens), {HY_STEPS} Euler "
        f"steps, MagCache hunyuanvideo-720p: Llava-Llama-3-8B (f32, hidden state 2 from the "
        f"last) and CLIP-L pooled on the card, random weights, the hash tokenizer")
    # the hash tokenizer splits the template's prefix into its words, not the
    # 95 tokens of the real tokenizer: crop those words instead
    crop = len(HYVIDEO_PROMPT_TEMPLATE.split("{}")[0].split())
    text = build_encoder(dev, f"Llava-Llama-3-8B (no output head; the template's prefix "
                              f"cropped at its {crop} hash-tokenizer words)",
                         lambda: LlamaTextEncoder(
                             LLAVA_LLAMA3_8B, out_len=HY_TXT, crop_start=crop, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(72)))
    pooled = build_encoder(dev, "CLIP-L", lambda: ClipTextEncoder(
        CLIP_L, device=dev, generator=torch.Generator(device=dev).manual_seed(73)))
    states, secs, gb = encode_twice(dev, lambda: text(TEXT_PROMPTS[:1]))
    # the prompt's words ("<|eot_id|>" rides on the last) and EOS
    n_words = len(TEXT_PROMPTS[0].split()) + 1
    if (tuple(states.shape) != (1, HY_TXT, 4096) or not bool(torch.isfinite(states).all())
            or not bool(states[0, :n_words].any(-1).all()) or bool(states[0, n_words:].any())):
        fail(f"Llama states {tuple(states.shape)}: not [1, {HY_TXT}, 4096], not finite, or "
             f"not nonzero exactly on the prompt's {n_words} tokens")
    log(f"  Llama encode {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second): "
        f"{tuple(states.shape)}, {n_words} prompt rows, std {float(states[0, :n_words].std()):.4f}"
        f"; peak {gb:.2f} GB")
    refiner_rounding(model, states)
    cfg = FramePackPipelineConfig(
        model="hunyuanvideo-720p", height=720, width=1280, pyramid=False, history_frames=0,
        latent_window_size=window, total_sections=1, steps=HY_STEPS, guidance=6.0,
        txt_len=HY_TXT, use_magcache=True, dtype="bfloat16")
    pipe = FramePackPipeline(cfg, dev, text_encoder=text, pooled_encoder=pooled, model=model)
    sched = compute_skip_schedule(pipe.cache_cfg())
    if int(sched.sum()) != HY_ELIDED:
        fail(f"hunyuanvideo-720p at {HY_STEPS} steps elides {int(sched.sum())}, not {HY_ELIDED}")
    _, launched = hy_request("HunyuanVideo 720p MagCache", pipe, sched,
                             (1, window, 90, 160, 16))
    log(f"  schedule ceiling {HY_STEPS / (HY_STEPS - HY_ELIDED):.3f}x ({HY_ELIDED} of "
        f"{HY_STEPS} elided)")
    return launched


def refiner_rounding(model, states):
    """The token refiner at full width on ``states`` as the pipeline runs it
    (K1 on bf16-rounded q, k, v in each of its blocks) against the same
    refiner with the plain attention in f32 on the card: fails past a rel L2
    of ``REFINER_TOL``."""
    from unittest import mock

    from magcache_tpu_torch.models import hunyuan as HY
    from magcache_tpu_torch.ops import attention as A

    t = torch.full((1,), 900.0, device=states.device)
    got = HY.refine_text(model, states, t)
    with mock.patch.object(HY, "_refiner_attention", A.flash_attention_bshd_plain):
        want = HY.refine_text(model, states, t)
    rel = rel_l2(got, want)
    worst = float((got - want).abs().max() / want.abs().max())
    log(f"  the token refiner ({model.cfg.refiner_depth} blocks, f32, {tuple(states.shape)} "
        f"Llama states, t = 900) with K1 on bf16-rounded q/k/v against the plain f32 "
        f"attention: rel L2 {rel:.3e} (tol {REFINER_TOL:.3e}), max |diff| / max |f32| "
        f"{worst:.3e}")
    if not bool(torch.isfinite(got).all()) or rel > REFINER_TOL:
        fail("the token refiner with the bf16 K1 call strays from the f32 refiner")


def phase_framepack_requests(dev, model):
    """Returns the launches of the padded, F1 and TeaCache requests."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.flux import image_to_grid_latent
    from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                        FramePackPipelineConfig)

    w, h = FP_SIZE
    log(f"phase 73: FramePack requests through FramePackPipeline.generate at {w}x{h}, "
        f"{FP_SECTIONS} sections of {FP_WINDOW} latent frames, {FP_STEPS} Euler steps each, "
        f"start latent from a seeded image (resized and channel-tiled, the CLI's path): the "
        f"padded mode (back to front) with MagCache framepack and F1 (forward) with "
        f"framepack-f1; then one TeaCache section (phase 74)")
    img = np.random.default_rng(73).random((480, 720, 3)).astype(np.float32)
    start = torch.from_numpy(np.ascontiguousarray(
        image_to_grid_latent(None, img, h // 8, w // 8, 16)))[None]
    launches = {}
    for key in ("framepack", "framepack-f1"):
        cfg = FramePackPipelineConfig(
            model=key, height=h, width=w, latent_window_size=FP_WINDOW,
            total_sections=FP_SECTIONS, steps=FP_STEPS, guidance=10.0, txt_len=HY_TXT,
            use_magcache=True, dtype="bfloat16")
        pipe = FramePackPipeline(cfg, dev, model=model)
        sched = compute_skip_schedule(pipe.cache_cfg())
        if int(sched.sum()) != FP_ELIDED:
            fail(f"{key} at {FP_STEPS} steps elides {int(sched.sum())}, not {FP_ELIDED}")
        frames = FP_SECTIONS * FP_WINDOW + (1 if key == "framepack" else 0)
        out, launches[key] = hy_request(f"{key} MagCache", pipe, sched,
                                        (1, frames, h // 8, w // 8, 16), start_latent=start)
        if key == "framepack" and not torch.equal(out.latents[0, 0].cpu(), start[0]):
            fail("framepack: the padded mode's video does not lead with the start latent")
        log(f"  {key}: schedule ceiling {FP_STEPS / (FP_STEPS - FP_ELIDED):.3f}x a section")
    log("phase 74: one FramePack TeaCache section (padded, pad 0) at the same shape, "
        "FRAMEPACK_TEA_COEFFS, threshold 0.15, the first and last step forced")
    cfg = FramePackPipelineConfig(
        height=h, width=w, latent_window_size=FP_WINDOW, total_sections=1, steps=FP_STEPS,
        guidance=10.0, txt_len=HY_TXT, use_teacache=True, dtype="bfloat16")
    out, tea = hy_request("framepack TeaCache", FramePackPipeline(cfg, dev, model=model), None,
                          (1, FP_WINDOW + 1, h // 8, w // 8, 16), start_latent=start)
    if out.skips[0, [0, -1]].any():
        fail("framepack TeaCache skipped a forced step")
    launches["framepack"] = {k: n + tea[k] for k, n in launches["framepack"].items()}
    return launches


def _numpy_hunyuan_tree(cfg, rng):
    """A random HunyuanVideo tree in the JAX package's layout: the FLUX tree
    of ``cfg.to_flux()``, the refiner and the clean-latent projections."""
    d, L = cfg.hidden, cfg.refiner_depth

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    tree = _numpy_flux_tree(cfg.to_flux(), rng)
    norms = {f"norm{i}_{p}": (1.0 if p == "w" else 0.0) + 0.1 * rng.standard_normal((L, d))
             for i in (1, 2) for p in "wb"}
    tree["refiner"] = {
        "in": lin(cfg.text_dim, d),
        "t_embed": {"in": lin(cfg.time_embed_dim, d), "out": lin(d, d)},
        "c_embed": {"in": lin(cfg.text_dim, d), "out": lin(d, d)},
        "blocks": dict(qkv=lin(d, 3 * d, L), proj=lin(d, d, L), mlp1=lin(d, 4 * d, L),
                       mlp2=lin(4 * d, d, L), mod=lin(d, 2 * d, L), **norms)}
    c = cfg.in_channels
    for name, k in (("clean_proj", 4), ("clean_proj_2x", 32), ("clean_proj_4x", 256)):
        tree[name] = lin(c * k, d)
    return tree


def _numpy_llama_tree(cfg, rng):
    d, L, hd = cfg.hidden, cfg.layers, cfg.head_dim

    def st(d_in, d_out):
        return {"w": rng.standard_normal((L, d_in, d_out)) / math.sqrt(d_in)}

    return {"embed": rng.standard_normal((cfg.vocab_size, d)) * 0.02,
            "final_norm": 1.0 + 0.1 * rng.standard_normal(d),
            "blocks": {"in_norm": 1.0 + 0.1 * rng.standard_normal((L, d)),
                       "post_norm": 1.0 + 0.1 * rng.standard_normal((L, d)),
                       "q": st(d, cfg.heads * hd), "k": st(d, cfg.kv_heads * hd),
                       "v": st(d, cfg.kv_heads * hd), "o": st(cfg.heads * hd, d),
                       "gate": st(d, cfg.intermediate), "up": st(d, cfg.intermediate),
                       "down": st(cfg.intermediate, d)}}


def phase_hunyuan_card_vs_cpu(dev):
    from magcache_tpu_torch.models.convert import (hunyuan_params_from_numpy,
                                                   llama_params_from_numpy)
    from magcache_tpu_torch.models.hunyuan import HunyuanConfig, HunyuanModel
    from magcache_tpu_torch.models.llama import LlamaConfig, LlamaModel, llama_hidden_states
    from magcache_tpu_torch.models.text import FallbackHashTokenizer
    from magcache_tpu_torch.pipelines.framepack import (FramePackPipeline,
                                                        FramePackPipelineConfig)

    log("phase 75: narrow HunyuanVideo (flat, no history) and FramePack (padded, 2 sections) "
        "pipelines on the card (kernels, bf16 MMDiT) against the CPU (plain ops, f32), 136 "
        "text tokens (the refiner's K1 runs); a narrow Llama, f32, card against CPU")
    cfg = HunyuanConfig(hidden=256, heads=2, depth_double=2, depth_single=2, text_dim=64,
                        vec_dim=32, time_embed_dim=64, framepack=True)
    tree = _numpy_hunyuan_tree(cfg, np.random.default_rng(75))
    steps, txt = 6, 136
    # per trunk run of 2 double + 2 single blocks: K1 4, K2h 12, K3 10; each
    # step's refiner K1 2 and head K3 1
    per_run = dict(NO_LAUNCHES, flash_attention_bshd=4, rms_norm_rope_head=12, layer_norm_mod=10)
    per_step = dict(NO_LAUNCHES, flash_attention_bshd=2, layer_norm_mod=1)
    for kind, kw in (("HunyuanVideo", dict(model="hunyuanvideo-544p", pyramid=False,
                                           history_frames=0, total_sections=1, height=32,
                                           width=48)),
                     ("FramePack", dict(model="framepack", total_sections=2, height=64,
                                        width=64))):
        outs = {}
        for name, device, dtype in (("card", dev, "bfloat16"),
                                    ("cpu", torch.device("cpu"), "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = HunyuanModel(c, device)
            model.load_state_dict(hunyuan_params_from_numpy(tree, c, device))
            pcfg = FramePackPipelineConfig(latent_window_size=2, steps=steps, txt_len=txt,
                                           use_magcache=True, dtype=dtype, **kw)
            pipe = FramePackPipeline(pcfg, device, model=model)
            rng = np.random.default_rng(76)
            draws = [rng.standard_normal((1,) + pipe.lat_shape).astype(np.float32)
                     for _ in range(pcfg.total_sections)]
            reset_counts()
            out = pipe.generate("a red boat at dawn", seed=2, start_latent=torch.full(
                (1,) + pipe.lat_shape[1:], 0.1),
                section_noise=lambda s, shape: torch.from_numpy(draws[s]))
            outs[name] = (out.latents.float().cpu(), read_counts(), out.skips)
        (got, launched, skips), (want, _, _) = outs["card"], outs["cpu"]
        if not skips.any():
            fail(f"narrow {kind}: no step skipped")
        runs, n = int((~skips).sum()), skips.size
        check_narrow(f"narrow {kind}", got, want, launched,
                     {k: per_run[k] * runs + per_step[k] * n for k in NO_LAUNCHES})
    lcfg = LlamaConfig(vocab_size=1000, hidden=256, layers=2, heads=2, kv_heads=1,
                       intermediate=512)
    ltree = _numpy_llama_tree(lcfg, np.random.default_rng(77))
    tok = FallbackHashTokenizer(lcfg.vocab_size)(TEXT_PROMPTS, max_length=24)
    outs = []
    for device in (dev, torch.device("cpu")):
        m = LlamaModel(lcfg, device)
        m.load_state_dict(llama_params_from_numpy(ltree, lcfg, device))
        outs.append(llama_hidden_states(m, tok["input_ids"], tok["attention_mask"],
                                        skip_layers=1).cpu())
    err = float((outs[0] - outs[1]).abs().max() / outs[1].abs().max())
    log(f"  narrow Llama (f32, skip 1, a padded prompt) card vs CPU: max |diff| / max |CPU| "
        f"{err:.3e} (tol 1e-4: f32 GEMMs without TF32)")
    if err > 1e-4 or not bool(torch.isfinite(outs[0]).all()):
        fail("narrow Llama: the card strays from the CPU")


# ------------------------------------------- Qwen-Image and Qwen-Image-Edit
# Qwen-Image at 1664x928: 58 x 104 = 6,032 packed image tokens, 256 text
# tokens, two CFG lanes a forward (true CFG). Per trunk run of its 60 double
# blocks: K1 (fixed max) once a block, K2 in head scope four times (q, k of
# each stream), K3 mod four times; every step's head adds one K3, skipped or
# not. Edit adds one reference's 6,032 tokens to the image stream.
QI_SIZE, QI_TXT, QI_STEPS = (1664, 928), 256, 20   # steps cut from 50
QI_GRID = (QI_SIZE[1] // 16, QI_SIZE[0] // 16)
QI_TRUNK_LAUNCHES = dict(NO_LAUNCHES, flash_attention_bshd=60, rms_norm_rope_head=240,
                         layer_norm_mod=240)
QI_SUFFIX = ", Ultra HD, 4K, cinematic composition."
# Qwen2's special tokens and their ids in its tokenizer
QWEN_SPECIAL = {"<|im_start|>": 151644, "<|im_end|>": 151645, "<|vision_start|>": 151652,
                "<|vision_end|>": 151653, "<|image_pad|>": 151655}


class QwenPieceTokenizer:
    """A stand-in for Qwen2's tokenizer without its files: the special tokens
    get their ids, the other pieces of a byte-level BPE pre-tokenizer's split
    (words with their leading space, "'s", punctuation runs, newlines) hash
    into [2, the lowest special id). It splits the Qwen-Image templates'
    prefixes into their published 34 and 64 tokens, so the pipelines' crops
    hold. Pads with 0 to ``max_length``, no EOS."""

    PIECES = re.compile(r"<\|[a-z_]+\|>| ?\w+|'s|[^\w\s]+\n?|\n")

    def __init__(self, special: dict):
        self.special = special
        self.span = min(special.values()) - 2

    def __call__(self, texts, padding=None, truncation=None, max_length=77,
                 return_tensors=None) -> dict:
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            toks = [self.special.get(p) or 2 + int.from_bytes(
                hashlib.sha256(p.encode()).digest()[:4], "little") % self.span
                for p in self.PIECES.findall(t)][:max_length]
            ids[i, :len(toks)] = toks
        return {"input_ids": ids, "attention_mask": (ids != 0).astype(np.int64)}


def qi_launches(runs: int, steps: int) -> dict:
    """Launches of Qwen-Image forwards: ``runs`` trunk runs, ``steps`` heads."""
    return {k: QI_TRUNK_LAUNCHES[k] * runs + (steps if k == "layer_norm_mod" else 0)
            for k in NO_LAUNCHES}


def check_qi_launches(label: str, launched: dict, runs: int, steps: int) -> None:
    want = qi_launches(runs, steps)
    modes = k1_modes()
    if launched != want or modes != {"fixed": 60 * runs, "running": 0}:
        fail(f"{label}: launches {launched} (K1 {modes}) != {want} for {runs} trunk runs and "
             f"{steps} steps")


def phase_qwen_kernels(dev, rec):
    """K2h over the image and text rope tables (Edit's reference block
    too), K1 over the joint sequences of text-to-image and Edit, and K3 mod
    on both streams, each against its plain version."""
    from magcache_tpu_torch.models.qwen_image import QWEN_IMAGE, qwen_image_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    H, D, d, L = 24, 128, 3072, QI_TXT
    n_img = math.prod(QI_GRID)
    log(f"phase 76: kernels vs plain at Qwen-Image 1664x928 shapes (bf16, 2 CFG lanes of "
        f"{n_img} image + {L} text tokens; Edit {2 * n_img} image tokens): K2 head scope, K1 "
        f"joint (fixed max), K3 mod")
    gen = torch.Generator(device=dev).manual_seed(76)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    fcfg = QWEN_IMAGE.to_flux()
    cos, sin = (torch.from_numpy(a).to(dev)
                for a in qwen_image_rope_tables(fcfg, L, *QI_GRID, 1))
    gain = 1.0 + rnd(D, dtype=torch.float32, scale=0.1)
    # K2 head scope on column slices of the fused projections, read in place
    # (phase 11's tolerance)
    for label, rows, col, tabs in (
            (f"image q, 2x{n_img} rows of 9216", n_img, 0, (cos[L:L + n_img], sin[L:L + n_img])),
            (f"text k, 2x{L} rows of 9216", L, d, (cos[:L], sin[:L])),
            (f"Edit image q, 2x{2 * n_img} rows of 9216, reference on index 1", 2 * n_img, 0,
             (cos[L:], sin[L:]))):
        x = rnd(2, rows, 3 * d, scale=2.0)[..., col:col + d]
        kw = dict(eps=1e-6, norm_scope="head")
        got = P.rms_norm_rope(x, gain, *tabs, H, **kw)
        want = P.rms_norm_rope_plain(x, gain, *tabs, H, **kw)
        err = compare(f"K2 rms_norm_rope [head scope, {label}]", got, want,
                      atol=3e-2, rtol=1.6e-2)
        ms = cuda_graph_ms(lambda: P.rms_norm_rope(x, gain, *tabs, H, **kw))
        pms = cuda_graph_ms(lambda: P.rms_norm_rope_plain(x, gain, *tabs, H, **kw))
        log(f"  K2h [{label}]: kernel {ms:.4f} ms ({2 * got.numel() * 2 / ms / 1e6:.0f} GB/s), "
            f"plain {pms:.4f} ms")
        keep(rec, "rms_norm_rope_head", err, ms, pms, "graph", label,
             elementwise_work(got, gain, *tabs))
        del x, got, want
    torch.cuda.empty_cache()

    # K1 over the joint [txt; img(; ref)] sequences with the static shift
    for label, S in ((f"joint 2x{L + n_img}x24x128 (1664x928)", L + n_img),
                     (f"Edit joint 2x{L + 2 * n_img}x24x128 (one reference)", L + 2 * n_img)):
        q, k, v = rnd(2, S, H, D), rnd(2, S, H, D), rnd(2, S, H, D)
        got = A.flash_attention_bshd(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
        want = A.flash_attention_bshd_plain(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
        err = compare(f"K1 flash_attention_bshd [{label}, fixed_max=16]", got, want,
                      atol=2e-3, rtol=2e-2)
        del want
        pms = cuda_ms(lambda: A.flash_attention_bshd_plain(
            q, k, v, fixed_max=A.QKNORM_FIXED_MAX), 1)
        ms = cuda_ms(lambda: A.flash_attention_bshd(q, k, v, fixed_max=16.0), 10)
        lms = sdpa_ms(q, k, v, 10)
        flops = 4 * 2 * H * S * S * D
        log(f"  K1 [{label}]: kernel {ms:.3f} ms ({rate(flops, 4 * nbytes(q), ms)}), plain "
            f"{pms:.3f} ms, SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop", label,
             (flops, 4 * nbytes(q)), ("F.scaled_dot_product_attention", lms))
        del q, k, v, got
        torch.cuda.empty_cache()

    # K3 mod on each stream; the CFG lanes share one modulation (the time
    # embedding alone: no pooled vector, no guidance), so F.layer_norm with
    # weight 1 + scale and bias shift computes the same function
    sc, sh = (rnd(1, 1, d, dtype=torch.float32, scale=0.3).expand(2, 1, d) for _ in "ab")
    wb, bb = (1.0 + sc[0]).view(-1).to(bf), sh[0].view(-1).to(bf)
    for label, rows in ((f"mod 2x{n_img}x3072 (image stream)", n_img),
                        (f"mod 2x{L}x3072 (text stream)", L)):
        x = rnd(2, rows, d, scale=2.0)
        got = P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6)
        want = P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6)
        err = compare(f"K3 layer_norm_mod [{label}]", got, want, atol=3e-2, rtol=1.6e-2)
        # CUDA-graph replays: the wrapper's host dispatch outlasts these calls
        ms = cuda_graph_ms(lambda: P.layer_norm_mod(x, scale=sc, shift=sh, eps=1e-6))
        pms = cuda_graph_ms(lambda: P.layer_norm_mod_plain(x, scale=sc, shift=sh, eps=1e-6))
        lms = cuda_graph_ms(lambda: torch.nn.functional.layer_norm(x, (d,), wb, bb, eps=1e-6))
        log(f"  K3 [{label}]: kernel {ms:.4f} ms ({2 * x.numel() * 2 / ms / 1e6:.0f} GB/s), "
            f"plain {pms:.4f} ms, F.layer_norm {lms:.4f} ms (graph)")
        keep(rec, "layer_norm_mod", err, ms, pms, "graph", label,
             elementwise_work(x, sc[:1], sh[:1]), ("F.layer_norm", lms))
        del x, got, want
    torch.cuda.empty_cache()


def make_qwen_model(dev):
    """Qwen-Image's 20.4 B MMDiT, bf16, random weights drawn on the card (one
    model for phases 77-79)."""
    from magcache_tpu_torch.models.qwen_image import QWEN_IMAGE, QwenImageModel

    cfg = dataclasses.replace(QWEN_IMAGE, dtype="bfloat16")
    torch.cuda.synchronize(dev)
    t0 = time.time()
    model = QwenImageModel(cfg, dev).init(torch.Generator(device=dev).manual_seed(77))
    model.requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  Qwen-Image bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB allocated")
    return model


def phase_qwen_forward(dev, model):
    """Returns each forward's launches: ``{"t2i": ..., "edit": ...}``."""
    from magcache_tpu_torch.models.qwen_image import make_qwen_image_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    gh, gw = QI_GRID
    n = gh * gw
    log(f"phase 77: full-shape Qwen-Image forwards (prepare -> trunk -> head), 60 double "
        f"blocks, 2 CFG lanes: text-to-image at 1664x928 ({n} image + {QI_TXT} text tokens) "
        f"and Edit with one reference ({2 * n} image tokens), twice each")
    gen = torch.Generator(device=dev).manual_seed(77)
    txt = MockTextEncoder(QI_TXT, 3584, scale=0.5)([TEXT_PROMPTS[0], " "], device=dev)
    x = torch.randn((2, n, 64), generator=gen, device=dev)
    ref = torch.randn((2, n, 64), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    launches = {}
    for key, refs, cond in (("t2i", 0, {"txt": txt}), ("edit", 1, {"txt": txt, "ref": ref})):
        core = make_qwen_image_core(model, QI_TXT, gh, gw, ref_images=refs)

        def forward():
            hidden, c = core.prepare(x, t, cond)
            return core.head(core.trunk(hidden, c), c)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        secs = []
        for _ in range(2):
            reset_counts()
            out, ms = timed_once(forward)
            secs.append(ms / 1e3)
        launched = read_counts()
        if tuple(out.shape) != (2, n, 64) or not bool(torch.isfinite(out).all()):
            fail(f"Qwen-Image {key} forward output {tuple(out.shape)} is not finite or "
                 f"misshapen")
        check_qi_launches(f"Qwen-Image {key} forward", launched, 1, 1)
        log(f"  {key} forward: {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second); "
            f"output {tuple(out.shape)} finite, std {float(out.std()):.4f}; {peak(dev)}; "
            f"launches K1 {launched['flash_attention_bshd']} ({k1_modes()}), K2h "
            f"{launched['rms_norm_rope_head']}, K3 {launched['layer_norm_mod']}")
        launches[key] = {k: 2 * c for k, c in launched.items()}    # both calls
    return launches


def qi_request(label, pipe, want_skips, **kw):
    """One request through ``pipe.generate``: fails unless the latents are
    finite of the packed shape, the skip bits are ``want_skips`` and the
    launches are those of the computed steps; returns the output and
    launches."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    prompt = TEXT_PROMPTS[0] + ("" if pipe.ref_images else QI_SUFFIX)
    out = pipe.generate(prompt, seed=3, **kw)
    launched = read_counts()
    lat, n = out.latents, math.prod(QI_GRID)
    if tuple(lat.shape) != (1, n, 64) or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or not (1, {n}, 64)")
    if not np.array_equal(out.skips, want_skips):
        fail(f"{label}: realized skips differ from skip_mask_for")
    runs = int((~out.skips.all(1)).sum())
    check_qi_launches(label, launched, runs, QI_STEPS)
    t = out.timings
    log(f"  {label}: {t['total_s']:.3f} s (text {t['text_s']:.3f} s); {int(out.skips.sum())} "
        f"of {out.skips.size} lane-forwards elided, {runs} trunk runs "
        f"({int((out.skips.sum(1) == 1).sum())} half-batch), skipped steps "
        f"{np.flatnonzero(out.skips.any(1)).tolist()}; latents std {float(lat.std()):.4f}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out, launched


def phase_qwen_request(dev, model):
    """Returns the requests' launches and the text encoder (its LM serves
    phase 79)."""
    from magcache_tpu_torch.models.llama import QWEN25_VL_7B
    from magcache_tpu_torch.models.text import (QWEN_IMAGE_CROP_START,
                                                QWEN_IMAGE_PROMPT_TEMPLATE, LlamaTextEncoder)
    from magcache_tpu_torch.pipelines.qwen_image import (QwenImagePipeline,
                                                         QwenImagePipelineConfig)

    w, h = QI_SIZE
    log(f"phase 78: Qwen-Image requests from the prompt through QwenImagePipeline.generate "
        f"at {w}x{h}, {QI_STEPS} Euler steps, true CFG 4.0: the Qwen2.5-VL-7B text tower "
        f"(f32, final-normed last state, the template's 34 prefix tokens cropped, a "
        f"special-token tokenizer) on the card beside the DiT; full compute, then MagCache "
        f"qwen-image")
    tok = QwenPieceTokenizer(QWEN_SPECIAL)
    text = build_encoder(dev, "Qwen2.5-VL-7B text tower (no output head)",
                         lambda: LlamaTextEncoder(
                             QWEN25_VL_7B, out_len=QI_TXT, skip_layers=0,
                             template=QWEN_IMAGE_PROMPT_TEMPLATE,
                             crop_start=QWEN_IMAGE_CROP_START, tokenizer=tok, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(78)))
    prompts = [TEXT_PROMPTS[0] + QI_SUFFIX, " "]
    states, secs, gb = encode_twice(dev, lambda: text(prompts))
    kept = tok([QWEN_IMAGE_PROMPT_TEMPLATE.format(p) for p in prompts],
               max_length=QI_TXT + QWEN_IMAGE_CROP_START)["attention_mask"][:, 34:].sum(1)
    rows = states.abs().sum(-1).gt(0).sum(1).tolist()
    if (tuple(states.shape) != (2, QI_TXT, 3584) or not bool(torch.isfinite(states).all())
            or rows != kept.tolist()):
        fail(f"Qwen states {tuple(states.shape)}: not [2, {QI_TXT}, 3584], not finite, or "
             f"nonzero rows {rows} != the tokens after the crop {kept.tolist()}")
    log(f"  Qwen LM encode {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second): "
        f"{tuple(states.shape)}, {rows} rows after the crop (prompt, negative \" \"), std "
        f"{float(states[0, :rows[0]].std()):.4f}; peak {gb:.2f} GB")
    base = dict(height=h, width=w, sample_steps=QI_STEPS, txt_len=QI_TXT, dtype="bfloat16")
    outs, launches = {}, dict(NO_LAUNCHES)
    for label, use in (("full compute", False), ("MagCache qwen-image", True)):
        pipe = QwenImagePipeline(QwenImagePipelineConfig(use_magcache=use, **base), dev,
                                 text_encoder=text, model=model)
        want = pipe.skip_mask_for(use_magcache=use)
        outs[label], launched = qi_request(f"Qwen-Image {label}", pipe, want)
        launches = {k: n + launched[k] for k, n in launches.items()}
    full, cached = outs["full compute"], outs["MagCache qwen-image"]
    ceiling = cached.skips.size / (cached.skips.size - int(cached.skips.sum()))
    log(f"  MagCache against full compute: {full.timings['total_s'] / cached.timings['total_s']:.3f}x "
        f"faster (schedule ceiling {ceiling:.3f}x: {int(cached.skips.sum())} of "
        f"{cached.skips.size} lane-forwards elided); rel L2 of the latents "
        f"{rel_l2(cached.latents, full.latents):.3e}")
    return launches, text


QI_EDIT_IMAGE_SEED = 79


def qwen_edit_reference(dev, model):
    """Phase 79's reference latents, encoded before phase 78 builds the LM:
    the Wan VAE's mid attention over 116 x 208 latents takes room that the LM
    would hold beside the DiT. Returns the packed latents."""
    from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE
    from magcache_tpu_torch.pipelines.qwen_image import (QwenImagePipeline,
                                                         QwenImagePipelineConfig)

    w, h = QI_SIZE
    log(f"phase 79, first part: the Edit reference, a seeded {h}x{w} image through the Wan "
        f"VAE encode (f32, random weights, one frame), packed 2x2, with the DiT resident")
    img = np.random.default_rng(QI_EDIT_IMAGE_SEED).random((h, w, 3)).astype(np.float32)
    vae = WanVAE(WAN21_VAE, dev).init(torch.Generator(device=dev).manual_seed(79))
    cfg = QwenImagePipelineConfig(model="qwen-image-edit", height=h, width=w, txt_len=QI_TXT,
                                  dtype="bfloat16")
    pipe = QwenImagePipeline(cfg, dev, model=model, vae=vae.requires_grad_(False))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ref, ms = timed_once(lambda: pipe.encode_image(img))
    if tuple(ref.shape) != (1, math.prod(QI_GRID), 64) or not bool(torch.isfinite(ref).all()):
        fail(f"Edit reference latents {tuple(ref.shape)} not finite or misshapen")
    log(f"  Wan VAE encode of the reference: {ms / 1e3:.3f} s, packed {tuple(ref.shape)}, std "
        f"{float(ref.std()):.4f}; {peak(dev)}")
    del pipe, vae
    torch.cuda.empty_cache()
    return ref


def phase_qwen_edit_request(dev, model, text, ref):
    """Returns the request's launches."""
    from magcache_tpu_torch.models.qwen_vl import (QWEN25_VL_VISION, QwenVLVisionTower,
                                                   preprocess_qwen_vl_image)
    from magcache_tpu_torch.models.text import QWEN_IMAGE_EDIT_PROMPT_TEMPLATE, QwenVLTextEncoder
    from magcache_tpu_torch.pipelines.qwen_image import (QwenImagePipeline,
                                                         QwenImagePipelineConfig)

    w, h = QI_SIZE
    # the image's merged tokens and the prompt fit txt_len: 96 tokens kept
    # for the prompt and the specials, as the CLI bounds it
    max_pixels = max(56 * 56, (QI_TXT - 96) * 28 * 28)
    log(f"phase 79: a Qwen-Image-Edit request from that image through QwenImagePipeline."
        f"generate at {w}x{h}, {QI_STEPS} Euler steps, MagCache qwen-image-edit: the image "
        f"through the Qwen2.5-VL vision tower (f32, at most {max_pixels} pixels) spliced "
        f"into phase 78's LM with M-RoPE, the reference latents from its first part")
    img = np.random.default_rng(QI_EDIT_IMAGE_SEED).random((h, w, 3)).astype(np.float32)
    tok = QwenPieceTokenizer(QWEN_SPECIAL)
    vision = QwenVLVisionTower(QWEN25_VL_VISION, dev).init(
        torch.Generator(device=dev).manual_seed(80))
    enc = QwenVLTextEncoder(text.cfg, out_len=QI_TXT, tokenizer=tok, max_pixels=max_pixels,
                            image_token_id=QWEN_SPECIAL["<|image_pad|>"], model=text.model,
                            vision_model=vision, device=dev)
    enc.set_image(img)
    _, grid = preprocess_qwen_vl_image(img, QWEN25_VL_VISION, max_pixels=max_pixels)
    n_merged = math.prod(grid) // 4
    expanded = QWEN_IMAGE_EDIT_PROMPT_TEMPLATE.replace("<|image_pad|>",
                                                       "<|image_pad|>" * n_merged)
    ids = tok([expanded.format(TEXT_PROMPTS[0])], max_length=QI_TXT + 64)["input_ids"]
    n_pads = int((ids == QWEN_SPECIAL["<|image_pad|>"]).sum())
    states, secs, gb = encode_twice(dev, lambda: enc([TEXT_PROMPTS[0], " "]))
    if n_pads != n_merged or not bool(torch.isfinite(states).all()):
        fail(f"Edit encode: {n_pads} image pads for {n_merged} merged vision tokens, or "
             f"non-finite states")
    log(f"  vision tower {sum(p.numel() for p in vision.parameters()) / 1e9:.3f} B params; "
        f"image grid {grid} -> {n_merged} merged tokens spliced at {n_pads} pads; Edit "
        f"encode {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second), states "
        f"{tuple(states.shape)}; peak {gb:.2f} GB")
    cfg = QwenImagePipelineConfig(model="qwen-image-edit", height=h, width=w,
                                  sample_steps=QI_STEPS, txt_len=QI_TXT, use_magcache=True,
                                  dtype="bfloat16")
    pipe = QwenImagePipeline(cfg, dev, text_encoder=enc, model=model)
    _, launched = qi_request("Qwen-Image-Edit MagCache", pipe, pipe.skip_mask_for(),
                             ref_latents=ref)
    return launched


def _numpy_qwen_vl_tree(cfg, rng):
    """A random Qwen2.5-VL vision tower tree in the JAX package's layout."""
    d, it, hu, L = cfg.hidden, cfg.intermediate, cfg.hidden * cfg.merge_unit, cfg.depth

    def lin(d_in, d_out, depth=None):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        return {"w": rng.standard_normal(shape) / math.sqrt(d_in),
                "b": rng.standard_normal(shape[:-2] + (d_out,)) * 0.02}

    return {"patch": rng.standard_normal((cfg.patch_dim, d)) / math.sqrt(cfg.patch_dim),
            "blocks": {"norm1": 1.0 + 0.1 * rng.standard_normal((L, d)),
                       "norm2": 1.0 + 0.1 * rng.standard_normal((L, d)),
                       "qkv": lin(d, 3 * d, L), "proj": lin(d, d, L), "gate": lin(d, it, L),
                       "up": lin(d, it, L), "down": lin(it, d, L)},
            "merger": {"ln": 1.0 + 0.1 * rng.standard_normal(d), "fc1": lin(hu, hu),
                       "fc2": lin(hu, cfg.out_hidden)}}


def phase_qwen_card_vs_cpu(dev):
    from magcache_tpu_torch.models.convert import (llama_params_from_numpy,
                                                   qwen_image_params_from_numpy,
                                                   qwen_vl_vision_params_from_numpy)
    from magcache_tpu_torch.models.llama import LlamaConfig, LlamaModel
    from magcache_tpu_torch.models.qwen_image import QwenImageConfig, QwenImageModel
    from magcache_tpu_torch.models.qwen_vl import (QwenVLVisionConfig, QwenVLVisionTower,
                                                   preprocess_qwen_vl_image)
    from magcache_tpu_torch.models.text import QwenVLTextEncoder
    from magcache_tpu_torch.pipelines.qwen_image import (QwenImagePipeline,
                                                         QwenImagePipelineConfig)

    log("phase 80: narrow Qwen-Image and Qwen-Image-Edit pipelines on the card (kernels, "
        "bf16) against the CPU (plain ops, f32), 2 blocks of 2 heads of 128, 48 text + 96 "
        "image tokens, steps skipped on both lanes and on one; a narrow vision tower and "
        "M-RoPE LM, f32, card against CPU")
    cfg = QwenImageConfig(hidden=256, heads=2, depth=2, text_dim=64, time_embed_dim=64)
    rng = np.random.default_rng(80)
    tree = _numpy_flux_tree(cfg.to_flux(), rng)
    tree["txt_norm"] = 1.0 + 0.1 * rng.standard_normal(cfg.text_dim)
    ref = torch.from_numpy(rng.standard_normal((1, 96, 64)).astype(np.float32))
    mask = np.array([[0, 0], [0, 0], [1, 1], [0, 0], [1, 0], [1, 1]], bool)
    # per trunk run of 2 double blocks: K1 2, K2h 8, K3 8; each step's head K3 1
    per_run = dict(NO_LAUNCHES, flash_attention_bshd=2, rms_norm_rope_head=8, layer_norm_mod=8)
    runs = int((~mask.all(1)).sum())
    expected = {k: per_run[k] * runs + (len(mask) if k == "layer_norm_mod" else 0)
                for k in NO_LAUNCHES}
    for key in ("qwen-image", "qwen-image-edit"):
        outs = {}
        for name, device, dtype in (("card", dev, "bfloat16"),
                                    ("cpu", torch.device("cpu"), "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = QwenImageModel(c, device)
            model.load_state_dict(qwen_image_params_from_numpy(tree, c, device))
            pcfg = QwenImagePipelineConfig(model=key, height=128, width=192,
                                           sample_steps=len(mask), txt_len=48, dtype=dtype)
            pipe = QwenImagePipeline(pcfg, device, model=model)
            reset_counts()
            out = pipe.generate("a red boat at dawn", seed=2, skip_override=mask,
                                ref_latents=ref if pipe.ref_images else None)
            outs[name] = (out.latents.float().cpu(), read_counts())
        (got, launched), (want, _) = outs["card"], outs["cpu"]
        check_narrow(f"narrow {key}", got, want, launched, expected)

    # the conditioning stack in f32: a 4-block tower of 2 heads of 128 (full
    # attention in blocks 1 and 3) and a 2-block LM with M-RoPE (16, 24, 24)
    vcfg = QwenVLVisionConfig(depth=4, hidden=256, heads=2, intermediate=512, out_hidden=256,
                              fullatt_indexes=(1, 3))
    lcfg = LlamaConfig(vocab_size=1000, hidden=256, layers=2, heads=2, kv_heads=1,
                       intermediate=512, rope_theta=1e6, eps=1e-6, qkv_bias=True)
    vtree = _numpy_qwen_vl_tree(vcfg, np.random.default_rng(81))
    ltree = _numpy_llama_tree(lcfg, np.random.default_rng(82))
    for n in ("q", "k", "v"):
        ltree["blocks"][n]["b"] = np.random.default_rng(83).standard_normal(
            ltree["blocks"][n]["w"].shape[::2]) * 0.1
    special = {k: 990 + i for i, k in enumerate(QWEN_SPECIAL)}
    img = np.random.default_rng(84).random((140, 196, 3)).astype(np.float32)
    patches, grid = preprocess_qwen_vl_image(img, vcfg)
    outs = {"tower": [], "stack": []}
    for device in (dev, torch.device("cpu")):
        tower = QwenVLVisionTower(vcfg, device)
        tower.load_state_dict(qwen_vl_vision_params_from_numpy(vtree, vcfg, device))
        lm = LlamaModel(lcfg, device)
        lm.load_state_dict(llama_params_from_numpy(ltree, lcfg, device))
        enc = QwenVLTextEncoder(lcfg, out_len=96, tokenizer=QwenPieceTokenizer(special),
                                image_token_id=special["<|image_pad|>"], model=lm,
                                vision_model=tower, device=device)
        outs["tower"].append(tower(patches, (grid,)).cpu())
        outs["stack"].append(enc.set_image(img)(TEXT_PROMPTS[:1]).cpu())
    for name, (got, want) in outs.items():
        err = float((got - want).abs().max() / want.abs().max())
        log(f"  narrow {name} (f32; grid {grid}, the stack: the Edit template with the "
            f"image's tokens spliced, M-RoPE) card vs CPU: max |diff| / max |CPU| {err:.3e} "
            f"(tol 1e-4: f32 GEMMs without TF32)")
        if err > 1e-4 or not bool(torch.isfinite(got).all()):
            fail(f"narrow Qwen2.5-VL {name}: the card strays from the CPU")


# ------------------------------------------------------------------ OmniGen2
# OmniGen2 at 1024x1024: a 64 x 64 grid of 4,096 image tokens and 128 text
# tokens; head dim 120 (21 query heads over 7 kv heads, repeated),
# zero-padded to 128 for K1 with the softmax scale of 120. K1 is the only
# kernel on the path: the q/k norm and RoPE stay the plain composition at
# head dim 120, as in JAX. Per program run K1 launches once in each of the
# trunk's 32 blocks, and in every prepare (skipped steps too) once in each
# of the noise refiner's 2 blocks and each reference's 2 ref-refiner
# blocks; the context refiner's 128 text tokens take attention()'s einsum
# path, as the JAX dispatcher does at that length (no launch).
# phase 83's requests: 20 steps (cut from the reference's 50 in PR 24)
OG_SIZE, OG_TXT, OG_STEPS, OG_SHORT, OG_CAL = 1024, 128, 20, 20, 10
OG_GRID = (OG_SIZE // 16, OG_SIZE // 16)
OG_TRUNK, OG_REFINER = 32, 2
OG_PROMPT = "A red sailboat glides across a calm bay at dawn."


def og_k1(skips, steps: int, refs: int, trunk: int = OG_TRUNK,
          refiner: int = OG_REFINER) -> int:
    """K1 launches of an OmniGen2 request: ``skips`` its realized bits
    ``[steps, lanes]`` (None: calibration, every lane computes), ``trunk``
    and ``refiner`` the blocks of the trunk and of each refiner. Text to
    image: one program, a trunk run wherever a lane computes. Edit: the
    with-refs program (cond and ref rows; its noise and ``refs`` reference
    refiners) and the ref-free one (uncond; its noise refiner)."""
    if skips is None:
        skips = np.zeros((steps, 3 if refs else 2), bool)
    if not refs:
        return trunk * int((~skips.all(1)).sum()) + refiner * steps
    runs_a = int((~(skips[:, 0] & skips[:, 2])).sum())
    runs_b = int((~skips[:, 1]).sum())
    return trunk * (runs_a + runs_b) + refiner * (2 + refs) * steps


def check_og_launches(label: str, launched: dict, k1: int) -> None:
    want = dict(NO_LAUNCHES, flash_attention_bshd=k1)
    if launched != want or k1_modes() != {"fixed": k1, "running": 0}:
        fail(f"{label}: launches {launched} (K1 {k1_modes()}) != K1 {k1} fixed and nothing "
             f"else")


def phase_omnigen2_kernels(dev, rec):
    """K1 at each OmniGen2 shape on q/k from the plain per-head RMS norm and
    RoPE (gains 1 + 0.1 N), the kv heads repeated; the plain q/k prologue's
    time at the with-refs shape."""
    from magcache_tpu_torch.models.omnigen2 import OMNIGEN2, omnigen2_rope_tables, repeat_kv
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops.fused_prologue import rms_norm_rope_plain

    H, HK, D, L = OMNIGEN2.heads, OMNIGEN2.kv_heads, OMNIGEN2.head_dim, OG_TXT
    n = math.prod(OG_GRID)
    log(f"phase 81: K1 vs plain at OmniGen2 1024x1024 shapes (bf16, head dim {D} zero-padded "
        f"to 128, {H} query heads over {HK} kv heads, fixed max), q/k from the plain RMS "
        f"norm + RoPE; SDPA at head dim {D} beside; the plain q/k prologue timed")
    gen = torch.Generator(device=dev).manual_seed(81)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    tabs = {refs: tuple(torch.from_numpy(a).to(dev) for a in
                        omnigen2_rope_tables(OMNIGEN2, L, OG_GRID, refs)) for refs in (0, 1)}
    gq, gk = (1.0 + rnd(D, dtype=torch.float32, scale=0.1) for _ in "qk")

    def qkv(b, rows, cos, sin):
        q = rms_norm_rope_plain(rnd(b, rows, H * D, scale=2.0), gq, cos, sin, H,
                                eps=OMNIGEN2.eps, norm_scope="head")
        k = rms_norm_rope_plain(rnd(b, rows, HK * D, scale=2.0), gk, cos, sin, HK,
                                eps=OMNIGEN2.eps, norm_scope="head")
        return q, repeat_kv(k, H // HK), repeat_kv(rnd(b, rows, HK, D), H // HK)

    cos1, sin1 = tabs[1]
    for label, b, rows, (cos, sin), launched in (
            (f"edit with-refs joint 2x{L + 2 * n}x{H}x{D} (text, reference, noise)", 2,
             L + 2 * n, tabs[1], "32 a with-refs trunk run"),
            (f"t2i joint 2x{L + n}x{H}x{D}", 2, L + n, tabs[0], "32 a trunk run"),
            (f"edit ref-free joint 1x{L + n}x{H}x{D} (uncond)", 1, L + n, tabs[0],
             "32 a ref-free trunk run"),
            (f"noise / ref refiner 2x{n}x{H}x{D}", 2, n, (cos1[L + n:], sin1[L + n:]),
             "2 a refiner, every prepare")):
        q, k, v = qkv(b, rows, cos, sin)
        k1_check(rec, f"K1 [{label}; {launched}]", label, q, k, v, A.QKNORM_FIXED_MAX,
                 big=rows > L + n)
        # the path's own call: attention() pads 120 -> 128, scale 1/sqrt(120)
        same = A.attention(q, k, v, fixed_max=A.QKNORM_FIXED_MAX)
        qp, kp, vp = (torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v))
        direct = A.flash_attention_bshd(qp, kp, vp, scale=D ** -0.5,
                                        fixed_max=A.QKNORM_FIXED_MAX)[..., :D]
        if not torch.equal(same, direct):
            fail(f"K1 [{label}]: attention() differs from the padded call at scale 1/sqrt({D})")
        del q, k, v, qp, kp, vp, same, direct
        torch.cuda.empty_cache()
    # the context refiner's 2x128 text tokens: attention()'s einsum path
    q, k, v = qkv(2, L, tabs[0][0][:L], tabs[0][1][:L])
    ems = cuda_ms(lambda: A.attention(q, k, v, fixed_max=A.QKNORM_FIXED_MAX), 10)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 128 - D)) for t in (q, k, v))
    kms = cuda_ms(lambda: A.flash_attention_bshd(qp, kp, vp, scale=D ** -0.5,
                                                 fixed_max=A.QKNORM_FIXED_MAX), 10)
    log(f"  context refiner 2x{L}x{H}x{D}: attention()'s einsum path {ems:.4f} ms (on the "
        f"path, no K1 launch); K1 at that shape {kms:.4f} ms (not launched on the path)")
    # the plain q/k prologue of one with-refs block: per-head RMS norm and RoPE
    xq, xk = rnd(2, L + 2 * n, H * D), rnd(2, L + 2 * n, HK * D)

    def prologue():
        rms_norm_rope_plain(xq, gq, cos1, sin1, H, eps=OMNIGEN2.eps, norm_scope="head")
        rms_norm_rope_plain(xk, gk, cos1, sin1, HK, eps=OMNIGEN2.eps, norm_scope="head")

    pms = cuda_ms(prologue, 5)
    moved = 2 * nbytes(xq, xk) + nbytes(cos1, sin1)
    b_ms, by = bound(ELEMENTWISE_OPS * (xq.numel() + xk.numel()), moved, H100_F32_TFLOPS)
    log(f"  plain q/k prologue (rms_norm_rope_plain, head scope, q and k) at 2x{L + 2 * n}x"
        f"({H} + {HK})x{D}: {pms:.3f} ms a block ({OG_TRUNK * pms:.1f} ms a with-refs trunk "
        f"run), bound {b_ms:.4f} ms by {by} ({b_ms / pms:.1%})")
    del xq, xk, q, k, v, qp, kp, vp
    torch.cuda.empty_cache()


def make_omnigen2_model(dev):
    """OmniGen2's 3.012 B DiT, bf16, random weights drawn on the card (one
    model for phases 82-84)."""
    from magcache_tpu_torch.models.omnigen2 import OMNIGEN2, OmniGen2Model

    torch.cuda.synchronize(dev)
    t0 = time.time()
    model = OmniGen2Model(dataclasses.replace(OMNIGEN2, dtype="bfloat16"), dev).init(
        torch.Generator(device=dev).manual_seed(82))
    model.requires_grad_(False)
    torch.cuda.synchronize(dev)
    log(f"  OmniGen2 bf16 random init on the card: {time.time() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
    return model


def phase_omnigen2_forward(dev, model):
    """Returns each program's launches over its two forwards: ``{"t2i": ...,
    "edit": ...}`` (edit: both programs)."""
    from magcache_tpu_torch.models.omnigen2 import make_omnigen2_core
    from magcache_tpu_torch.models.text import MockTextEncoder

    n = math.prod(OG_GRID)
    log(f"phase 82: full-shape OmniGen2 forwards (prepare with the refiners -> 32-block "
        f"trunk -> head) at 1024x1024, twice each: text-to-image (2 rows of {OG_TXT} + {n} "
        f"tokens), edit with-refs (2 rows of {OG_TXT + 2 * n}: cond and ref, one reference) "
        f"and edit ref-free (1 row of {OG_TXT + n}: uncond); one profiled with-refs forward")
    gen = torch.Generator(device=dev).manual_seed(82)
    txt = MockTextEncoder(OG_TXT, model.cfg.text_dim, scale=0.5)(
        [OG_PROMPT, "blurry", "<ref-image-only>"], device=dev)
    x = torch.randn((2, 128, 128, 16), generator=gen, device=dev)
    ref = torch.randn((2, 1, 128, 128, 16), generator=gen, device=dev)
    t = torch.full((2,), 900.0, device=dev)
    launches = {"t2i": dict(NO_LAUNCHES), "edit": dict(NO_LAUNCHES)}
    for key, label, refs, rows, cond in (
            ("t2i", "text-to-image", 0, 2, {"txt": txt[:2]}),
            ("edit", "edit with-refs", 1, 2, {"txt": txt[[0, 2]], "ref": ref}),
            ("edit", "edit ref-free", 0, 1, {"txt": txt[1:2]})):
        core = make_omnigen2_core(model, OG_TXT, OG_GRID, refs)

        def forward():
            hidden, c = core.prepare(x[:rows], t[:rows], cond)
            return core.head(core.trunk(hidden, c), c)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        secs = []
        reset_counts()
        for _ in range(2):
            out, ms = timed_once(forward)
            secs.append(ms / 1e3)
        launched = read_counts()
        if tuple(out.shape) != (rows, 128, 128, 16) or not bool(torch.isfinite(out).all()):
            fail(f"OmniGen2 {label} forward output {tuple(out.shape)} is not finite or "
                 f"misshapen")
        per = OG_TRUNK + OG_REFINER * (1 + refs)
        check_og_launches(f"OmniGen2 {label} forwards", launched, 2 * per)
        log(f"  {label} forward: {secs[0]:.3f} s (first call), {secs[1]:.3f} s (second); "
            f"output {tuple(out.shape)} finite, std {float(out.std()):.4f}; {peak(dev)}; K1 "
            f"{per} a forward ({OG_TRUNK} trunk + {OG_REFINER * (1 + refs)} refiner)")
        launches[key] = {k: launches[key][k] + c for k, c in launched.items()}
        if label == "edit with-refs":
            profile_forward("edit with-refs forward", core, x, t, cond)
    return launches


def og_request(label, pipe, want_skips, **kw):
    """One request through ``pipe.generate``: fails unless the latents are
    finite and shaped, the skip bits are ``want_skips`` (None: calibration)
    and K1's launches are those of the computed runs and the prepares;
    returns the output and launches."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = pipe.generate(OG_PROMPT, seed=3, **kw)
    launched = read_counts()
    lat, steps = out.latents, pipe.config.num_inference_steps
    if tuple(lat.shape) != (1, 128, 128, 16) or not bool(torch.isfinite(lat).all()):
        fail(f"{label}: latents {tuple(lat.shape)} not finite or not (1, 128, 128, 16)")
    if (out.skips is None) != (want_skips is None) or (
            want_skips is not None and not np.array_equal(out.skips, want_skips)):
        fail(f"{label}: realized skips differ from the schedule")
    check_og_launches(label, launched, og_k1(out.skips, steps, pipe.n_refs))
    t = out.timings
    what = "calibration, full compute"
    if out.skips is not None:
        s = out.skips
        what = (f"{int(s.sum())} of {s.size} lane-forwards elided, skipped steps "
                f"{np.flatnonzero(s.any(1)).tolist()}")
        if pipe.n_refs:
            what += (f"; with-refs trunk runs {int((~(s[:, 0] & s[:, 2])).sum())} "
                     f"({int((s[:, 0] != s[:, 2]).sum())} half-batch), ref-free "
                     f"{int((~s[:, 1]).sum())}")
    log(f"  {label}: {t['total_s']:.3f} s (text {t['text_s']:.3f} s); {what}; K1 "
        f"{launched['flash_attention_bshd']}; latents std {float(lat.std()):.4f}; peak "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return out, launched


def og_ref_latents(dev):
    gen = torch.Generator(device=dev).manual_seed(83)
    return torch.randn((1, 1, 128, 128, 16), generator=gen, device=dev)


def og_pipeline(dev, model, **kw):
    from magcache_tpu_torch.pipelines.omnigen2 import OmniGen2Pipeline, OmniGen2PipelineConfig

    cfg = OmniGen2PipelineConfig(height=OG_SIZE, width=OG_SIZE, txt_len=OG_TXT,
                                 dtype="bfloat16", **kw)
    return OmniGen2Pipeline(cfg, dev, model=model)


def og_token_ceiling(skips, n_refs):
    """Edit's ceiling in token-forwards: the with-refs rows carry ``128 + (R
    + 1) * 4,096`` tokens, the uncond row ``128 + 4,096``; the refiners run
    every step either way and are not counted."""
    n = math.prod(OG_GRID)
    big, small = OG_TXT + (n_refs + 1) * n, OG_TXT + n
    cost = np.array([big, small, big], float)
    return float((cost * len(skips)).sum() / (cost * ~skips).sum())


def phase_omnigen2_requests(dev, model):
    """Returns the requests' launches: ``{"t2i": ..., "edit": ...}``."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.pipelines.omnigen2 import make_omnigen2_cache_config

    log(f"phase 83: OmniGen2 requests through OmniGen2Pipeline.generate at "
        f"{OG_SIZE}x{OG_SIZE}, {OG_STEPS} Euler steps (text guidance 5.0, image 2.0): "
        f"text-to-image full compute and MagCache (omnigen2-t2i_*), then edit with one seeded "
        f"reference latent, full compute and MagCache (omnigen2-edit_*: cond and ref on the "
        f"with-refs program, uncond on the ref-free one)")
    ref = og_ref_latents(dev)
    launches = {"t2i": dict(NO_LAUNCHES), "edit": dict(NO_LAUNCHES)}
    for mode in ("t2i", "edit"):
        lanes = 2 if mode == "t2i" else 3
        sched = compute_skip_schedule(make_omnigen2_cache_config(mode, OG_STEPS)).reshape(
            OG_STEPS, lanes)
        outs = {}
        for use in (False, True):
            pipe = og_pipeline(dev, model, mode=mode, num_inference_steps=OG_STEPS,
                               use_magcache=use)
            want = sched if use else np.zeros_like(sched)
            name = f"OmniGen2 {mode} {'MagCache' if use else 'full compute'}"
            outs[use], launched = og_request(name, pipe, want,
                                             **(dict(ref_latents=ref) if mode == "edit"
                                                else {}))
            launches[mode] = {k: n + launched[k] for k, n in launches[mode].items()}
        full, cached = outs[False], outs[True]
        ceiling = sched.size / (sched.size - int(sched.sum()))
        extra = (f"; in token-forwards of the trunks {og_token_ceiling(sched, 1):.3f}x (the "
                 f"uncond row carries {OG_TXT + math.prod(OG_GRID)} tokens, the others "
                 f"{OG_TXT + 2 * math.prod(OG_GRID)})" if mode == "edit" else "")
        log(f"  {mode} MagCache against {mode} full compute (wall time of generate, the "
            f"refiners and heads of every step included): "
            f"{full.timings['total_s'] / cached.timings['total_s']:.3f}x faster; schedule "
            f"ceiling {ceiling:.3f}x in lane-forwards ({int(sched.sum())} of {sched.size} "
            f"elided){extra}; rel L2 of the latents {rel_l2(cached.latents, full.latents):.3e}")
    return launches


def phase_omnigen2_policies(dev, model):
    """Returns the requests' launches (edit)."""
    from magcache_tpu_torch.core.magcache import compute_skip_schedule
    from magcache_tpu_torch.core.taylorseer import taylorseer_schedule
    from magcache_tpu_torch.pipelines.omnigen2 import make_omnigen2_cache_config

    n = OG_SHORT
    log(f"phase 84: OmniGen2 edit requests at {OG_SIZE}x{OG_SIZE} (cut from 50 steps), one "
        f"seeded reference: TaylorSeer (interval 4, order 2, warm-up 3) and DPM-Solver++(2M) "
        f"with MagCache at {n} steps; TeaCache (relative L1, threshold 0.05, first and last "
        f"steps forced) and a calibration run at {OG_CAL} steps")
    ref = og_ref_latents(dev)
    launches = dict(NO_LAUNCHES)
    sched = compute_skip_schedule(make_omnigen2_cache_config("edit", n)).reshape(n, 3)
    for label, kw in (("TaylorSeer", dict(enable_taylorseer=True)),
                      ("TeaCache", dict(enable_teacache=True)),
                      ("dpm++ MagCache", dict(scheduler="dpmsolver++", use_magcache=True)),
                      ("calibration", dict(magcache_calibration=True))):
        steps = OG_CAL if label in ("TeaCache", "calibration") else n
        pipe = og_pipeline(dev, model, mode="edit", num_inference_steps=steps, **kw)
        if label == "TaylorSeer":
            fresh = taylorseer_schedule(pipe._ts_config())[0]
            want = np.repeat(~fresh[:, None], 3, axis=1)
        elif label == "dpm++ MagCache":
            want = sched
        else:
            want = None
        if label == "TeaCache":
            reset_counts()
            out = pipe.generate(OG_PROMPT, seed=3, ref_latents=ref)
            if out.skips[[0, -1]].any():
                fail("OmniGen2 TeaCache: a forced first or last step was skipped")
            launched = read_counts()
            check_og_launches("OmniGen2 TeaCache", launched, og_k1(out.skips, steps, 1))
            log(f"  OmniGen2 edit TeaCache: {out.timings['total_s']:.3f} s; "
                f"{int(out.skips.sum())} of {out.skips.size} lane-forwards elided "
                f"(by lane {out.skips.sum(0).tolist()}), steps 0 and {steps - 1} computed; K1 "
                f"{launched['flash_attention_bshd']}")
        else:
            out, launched = og_request(f"OmniGen2 edit {label}", pipe, want, ref_latents=ref)
        if label == "TaylorSeer":
            log(f"    TaylorSeer computed {int(fresh.sum())} of {n} steps "
                f"({np.flatnonzero(fresh).tolist()}), as taylorseer_schedule gives")
        if label == "calibration":
            ratios = np.asarray(out.calibration["norm_ratio"])
            if ratios.shape != ((steps - 1) * 3,) or not np.isfinite(ratios).all():
                fail(f"OmniGen2 calibration: {ratios.shape} ratios, finite "
                     f"{bool(np.isfinite(ratios).all())}")
            log(f"    calibration: {ratios.size} finite ratios (cond, uncond, ref a step), "
                f"steps 1-3: {ratios[:9].round(4).tolist()}")
        launches = {k: c + launched[k] for k, c in launches.items()}
    return launches


def _numpy_omnigen2_tree(cfg, rng):
    """A random OmniGen2 tree in the JAX package's layout (depth-stacked
    blocks, ``w: [d_in, d_out]``)."""
    d, dk, f = cfg.hidden, cfg.kv_heads * cfg.head_dim, cfg.ffn_dim

    def lin(d_in, d_out, depth=None, bias=True):
        shape = (d_in, d_out) if depth is None else (depth, d_in, d_out)
        p = {"w": rng.standard_normal(shape) / math.sqrt(d_in)}
        if bias:
            p["b"] = rng.standard_normal(shape[:-2] + (d_out,)) * 0.02
        return p

    def blocks(depth, modulated):
        g = {"q": lin(d, d, depth, False), "kv": lin(d, 2 * dk, depth, False),
             "o": lin(d, d, depth, False), "w1": lin(d, f, depth, False),
             "w3": lin(d, f, depth, False), "w2": lin(f, d, depth, False)}
        for n, w in (("q_norm", cfg.head_dim), ("k_norm", cfg.head_dim), ("norm1", d),
                     ("norm2", d), ("ffn_norm1", d), ("ffn_norm2", d)):
            g[n] = 1.0 + 0.1 * rng.standard_normal((depth, w))
        if modulated:
            g["mod"] = lin(cfg.temb_dim, 4 * d, depth)
        return g

    pin = cfg.patch_in
    return {"t_embed": {"in": lin(cfg.time_embed_dim, cfg.temb_dim),
                        "out": lin(cfg.temb_dim, cfg.temb_dim)},
            "cap_norm": 1.0 + 0.1 * rng.standard_normal(cfg.text_dim),
            "cap_proj": lin(cfg.text_dim, d), "x_embed": lin(pin, d), "ref_embed": lin(pin, d),
            "context_refiner": blocks(cfg.refiner_layers, False),
            "noise_refiner": blocks(cfg.refiner_layers, True),
            "ref_refiner": blocks(cfg.refiner_layers, True),
            "layers": blocks(cfg.layers, True),
            "norm_out_mod": lin(cfg.temb_dim, d), "final_out": lin(d, pin)}


def phase_omnigen2_card_vs_cpu(dev):
    from magcache_tpu_torch.models.convert import omnigen2_params_from_numpy
    from magcache_tpu_torch.models.omnigen2 import OmniGen2Config, OmniGen2Model
    from magcache_tpu_torch.pipelines.omnigen2 import OmniGen2Pipeline, OmniGen2PipelineConfig

    cfg = OmniGen2Config(hidden=480, heads=4, kv_heads=2, layers=2, refiner_layers=1,
                         text_dim=64, time_embed_dim=64, temb_dim=128)
    log(f"phase 85: narrow OmniGen2 pipelines on the card (K1, bf16) against the CPU (plain "
        f"ops, f32): hidden 480, {cfg.heads} heads over {cfg.kv_heads} of {cfg.head_dim} (the "
        f"pad to 128), 2 + 1 refiner blocks, 16 text + 144 image tokens a picture, 8 Euler "
        f"steps of MagCache at E 0.3: text-to-image, and edit with 2 references")
    rng = np.random.default_rng(85)
    tree = _numpy_omnigen2_tree(cfg, rng)
    refs = torch.from_numpy(rng.standard_normal((1, 2, 24, 24, 16)).astype(np.float32))
    for mode in ("t2i", "edit"):
        outs = {}
        for name, device, dtype in (("card", dev, "bfloat16"),
                                    ("cpu", torch.device("cpu"), "float32")):
            c = dataclasses.replace(cfg, dtype=dtype)
            model = OmniGen2Model(c, device)
            model.load_state_dict(omnigen2_params_from_numpy(tree, c, device))
            pcfg = OmniGen2PipelineConfig(mode=mode, height=192, width=192,
                                          num_inference_steps=8, txt_len=16, dtype=dtype,
                                          use_magcache=True, magcache_thresh=0.3, ref_images=2)
            pipe = OmniGen2Pipeline(pcfg, device, model=model)
            reset_counts()
            out = pipe.generate("a red boat at dawn", seed=2,
                                ref_latents=refs if mode == "edit" else None)
            outs[name] = (out.latents.float().cpu(), read_counts(), out.skips)
        (got, launched, skips), (want, _, cpu_skips) = outs["card"], outs["cpu"]
        if not np.array_equal(skips, cpu_skips) or not skips.any():
            fail(f"narrow OmniGen2 {mode}: skips differ between card and CPU, or none")
        k1 = og_k1(skips, 8, 2 if mode == "edit" else 0, cfg.layers, cfg.refiner_layers)
        check_narrow(f"narrow OmniGen2 {mode} (skips by lane {skips.sum(0).tolist()})", got,
                     want, launched, dict(NO_LAUNCHES, flash_attention_bshd=k1))


# -------------------------------- serving and evaluation, Wan2.1 T2V-1.3B
SERVE_PROMPTS = ("A red sailboat glides across a calm bay at dawn.",
                 "A litter of golden retriever puppies playing in the snow.")
SERVE_HTTP_S = 300          # the longest a loopback HTTP call may take
SERVE_SUBPROCESS_S = 300    # the cli.serve subprocess: start to its first answer


def http_json(method: str, url: str, payload=None, timeout: float = SERVE_HTTP_S):
    """``(status, body)`` of one loopback HTTP call, error statuses included."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def served_latents(rec: dict) -> torch.Tensor:
    import base64
    import io

    return torch.from_numpy(np.load(io.BytesIO(base64.b64decode(rec["result"]["latents_b64"]))))


def trunk_runs(mask: np.ndarray) -> int:
    """Steps on which some lane computes: one trunk run each."""
    return int((~mask.all(1)).sum())


def batch4_kernel_checks(dev, rec) -> None:
    """K1 (self and cross), K2 token scope and K3 (mod, affine) at the
    micro-batch's shape, 2 prompts x 2 CFG lanes of 7,800 tokens, against
    their plain versions with phase 3's tolerances."""
    from magcache_tpu_torch.models.wan import WAN_1_3B, wan_rope_tables
    from magcache_tpu_torch.ops import attention as A
    from magcache_tpu_torch.ops import fused_prologue as P

    gen = torch.Generator(device=dev).manual_seed(86)
    B, S, H, D, L, bf = 4, 5 * 30 * 52, 12, 128, 512, torch.bfloat16

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    q, k, v = rnd(B, S, H, D), rnd(B, S, H, D), rnd(B, S, H, D)
    ck, cv = rnd(B, L, H, D), rnd(B, L, H, D)
    for label, (kk, vv) in (("self", (k, v)), ("cross 512 keys", (ck, cv))):
        got = A.flash_attention_bshd(q, kk, vv, fixed_max=16.0)
        want = A.flash_attention_bshd_plain(q, kk, vv, fixed_max=16.0)
        err = compare(f"K1 flash_attention_bshd [micro-batch 4x{S} {label}, fixed_max=16]",
                      got, want, atol=2e-3, rtol=2e-2)
        ms = cuda_ms(lambda: A.flash_attention_bshd(q, kk, vv, fixed_max=16.0), 5)
        pms = cuda_ms(lambda: A.flash_attention_bshd_plain(q, kk, vv, fixed_max=16.0), 2)
        lms = sdpa_ms(q, kk, vv, 5)
        flops = 4 * B * H * S * kk.shape[1] * D
        moved = 2 * nbytes(q) + nbytes(kk, vv)
        log(f"  K1 [4x{S} {label}]: kernel {ms:.3f} ms ({rate(flops, moved, ms)}), plain "
            f"{pms:.3f} ms, SDPA {lms:.3f} ms")
        keep(rec, "flash_attention_bshd", err, ms, pms, "loop",
             f"4x{S}x12x128 micro-batch {label}", (flops, moved),
             ("F.scaled_dot_product_attention", lms))
    del q, k, v, ck, cv
    x = rnd(B, S, H * D, scale=2.0)
    gain = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    cos_np, sin_np = wan_rope_tables(WAN_1_3B, (5, 30, 52))
    cos, sin = torch.from_numpy(cos_np).to(dev), torch.from_numpy(sin_np).to(dev)
    err = compare(f"K2 rms_norm_rope [micro-batch 4x{S}, token scope]",
                  P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6),
                  P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6), atol=3e-2, rtol=1.6e-2)
    ms = cuda_ms(lambda: P.rms_norm_rope(x, gain, cos, sin, H, eps=1e-6))
    pms = cuda_ms(lambda: P.rms_norm_rope_plain(x, gain, cos, sin, H, eps=1e-6))
    log(f"  K2 [4x{S}]: kernel {ms:.3f} ms, plain {pms:.3f} ms")
    keep(rec, "rms_norm_rope", err, ms, pms, "loop", f"4x{S}x1536 micro-batch",
         elementwise_work(x, gain, cos, sin))
    sc = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    sh = rnd(B, 1, H * D, dtype=torch.float32, scale=0.1)
    w = 1.0 + rnd(H * D, dtype=torch.float32, scale=0.1)
    bias = rnd(H * D, dtype=torch.float32, scale=0.1)
    for label, kw in (("mod", dict(scale=sc, shift=sh)), ("affine", dict(weight=w, bias=bias))):
        err = compare(f"K3 layer_norm_mod [micro-batch 4x{S} {label}]",
                      P.layer_norm_mod(x, eps=1e-6, **kw),
                      P.layer_norm_mod_plain(x, eps=1e-6, **kw), atol=3e-2, rtol=1.6e-2)
        ms = cuda_ms(lambda: P.layer_norm_mod(x, eps=1e-6, **kw))
        pms = cuda_ms(lambda: P.layer_norm_mod_plain(x, eps=1e-6, **kw))
        lib = None
        if label == "affine":
            wb, bb = w.to(x.dtype), bias.to(x.dtype)
            lib = ("F.layer_norm", cuda_ms(lambda: torch.nn.functional.layer_norm(
                x, (H * D,), wb, bb, eps=1e-6)))
        log(f"  K3 [4x{S} {label}]: kernel {ms:.3f} ms, plain {pms:.3f} ms"
            + (f", F.layer_norm {lib[1]:.3f} ms" if lib else ""))
        keep(rec, "layer_norm_mod", err, ms, pms, "loop", f"4x{S}x1536 micro-batch {label}",
             elementwise_work(x, *kw.values()), lib)


def serve_cli_subprocess(want_skips: np.ndarray, served: torch.Tensor) -> None:
    """``python -m magcache_tpu_torch.cli.serve`` at the served config as a
    process of its own: read its address, POST one request at its config's
    schedule, check it against the in-process served latents (the same
    seeded weights), stop it with SIGINT and require exit code 0."""
    import os
    import signal
    import sys
    import threading

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "magcache_tpu_torch.cli.serve", "--task", "t2v-1.3B",
           "--frame_num", "17", "--sample_steps", str(STEPS), "--use_magcache", "--port", "0"]
    log(f"  subprocess: {' '.join(cmd[1:])}")
    t0 = time.time()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONPATH=root))
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=read, daemon=True).start()
    try:
        while not any(l.startswith("serving ") for l in lines):
            if proc.poll() is not None or time.time() - t0 > SERVE_SUBPROCESS_S:
                fail(f"cli.serve did not start (exit {proc.poll()}): {''.join(lines)[-2000:]}")
            time.sleep(0.1)
        line = next(l for l in lines if l.startswith("serving "))
        addr = line.split(" on ")[1].split()[0]
        t_up = time.time() - t0
        code, rec = http_json("POST", addr + "/generate",
                              {"prompt": WAN_PROMPT, "seed": 3, "return_latents": True})
        t_req = time.time() - t0 - t_up
        if code != 200 or rec.get("status") != "done":
            fail(f"cli.serve answered {code}: {rec}")
        res = rec["result"]
        if (res["skipped_forwards"], res["total_forwards"]) != (int(want_skips.sum()),
                                                                want_skips.size):
            fail(f"cli.serve skipped {res['skipped_forwards']} of {res['total_forwards']}, "
                 f"not {int(want_skips.sum())} of {want_skips.size}")
        lat = served_latents(rec)
        if tuple(lat.shape) != (1, 5, 60, 104, 16) or not bool(torch.isfinite(lat).all()):
            fail(f"cli.serve latents {tuple(lat.shape)} not finite or misshapen")
        err = rel_l2(lat, served)
        log(f"  {line.strip()}: up in {t_up:.1f} s (torch, the random 1.3 B model); one "
            f"request {t_req:.3f} s round trip (wall_s {rec['wall_s']}, queue_wait_s "
            f"{rec['queue_wait_s']}); {res['skipped_forwards']} of {res['total_forwards']} "
            f"lane-forwards skipped; latents against the in-process served ones: "
            f"{'bit-equal' if torch.equal(lat, served) else f'rel L2 {err:.3e}'}")
        if err > 1e-2:
            fail(f"cli.serve latents {err:.3e} rel L2 from the in-process ones")
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=60)
        log(f"  SIGINT: cli.serve exited {rc} after {time.time() - t0:.1f} s in all")
        if rc != 0:
            fail(f"cli.serve exited {rc} on SIGINT: {''.join(lines)[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def phase_serve(dev, model, rec):
    """Returns the in-process served requests' launches."""
    import threading

    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig
    from magcache_tpu_torch.serve import PipelineServer, make_http_server

    log(f"phase 86: Wan2.1 T2V-1.3B served over loopback HTTP, 832x480x17, {STEPS} UniPC "
        f"steps, MagCache E012K2R02: PipelineServer(max_batch=2) behind make_http_server; a "
        f"warmup pair, per-request E/K/R overrides, an async job, two concurrent requests "
        f"micro-batched (2 prompts x 2 CFG lanes), /healthz and /info; then cli.serve as a "
        f"subprocess")
    pipe = WanPipeline(WanPipelineConfig(use_magcache=True, size=(832, 480), frame_num=17,
                                         sample_steps=STEPS, sample_shift=5.0,
                                         guide_scale=5.0), dev, model=model)
    batches = []
    generate_batch = pipe.generate_batch

    def recording_batch(prompts, **kw):         # keeps each batch's latents
        out = generate_batch(prompts, **kw)
        batches.append((list(prompts), list(kw["seeds"]), out.latents.float().cpu()))
        return out

    pipe.generate_batch = recording_batch
    sched = pipe.skip_mask_for()
    overrides = {"E012K2R02": dict(magcache_thresh=0.12, magcache_K=2, retention_ratio=0.2),
                 "full compute": dict(use_magcache=False),
                 "E024K6R02": dict(magcache_thresh=0.24, magcache_K=6, retention_ratio=0.2)}
    masks = {name: pipe.skip_mask_for(
        thresh=o.get("magcache_thresh"), K=o.get("magcache_K"),
        retention_ratio=o.get("retention_ratio"), use_magcache=o.get("use_magcache", True))
        for name, o in overrides.items()}
    if not np.array_equal(masks["E012K2R02"], sched) or not (
            0 < sched.sum() < masks["E024K6R02"].sum()):
        fail("the override masks do not order as E012K2R02 = the config's < E024K6R02")
    server = PipelineServer(pipe, steps=STEPS, max_batch=2, batch_window_s=1.0)
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % httpd.server_address[1]
    done, runs, peaks = {}, 0, []

    def post(label, payload, want_code=200):
        code, body = http_json("POST", base + "/generate", payload)
        if code != want_code:
            fail(f"{label}: HTTP {code}, not {want_code}: {body}")
        return body

    def post_concurrent(label, payloads):
        """Two POSTs at once: the executor batches them in its window."""
        got = [None] * len(payloads)

        def one(i):
            got[i] = http_json("POST", base + "/generate", payloads[i])

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(SERVE_HTTP_S)
        for i, res in enumerate(got):
            if res is None or res[0] != 200:
                fail(f"{label} {i}: {res}")
            if res[1]["result"].get("batched") != len(payloads):
                fail(f"{label} {i}: batched {res[1]['result'].get('batched')}, not "
                     f"{len(payloads)}")
        jobs = [server.get(body["job_id"]) for _, body in got]
        if len({j.started_at for j in jobs}) != 1:
            fail(f"{label}: the requests did not share one executor pass")
        return [body for _, body in got]

    def check(label, body, mask, batched=None, count=True):
        nonlocal runs
        if body.get("status") != "done":
            fail(f"{label}: status {body.get('status')}: {body.get('error')}")
        res = body["result"]
        if res["latents_shape"] != [1, 5, 60, 104, 16]:
            fail(f"{label}: latents_shape {res['latents_shape']}")
        if batched is not None and res.get("batched") != batched:
            fail(f"{label}: batched {res.get('batched')}, not {batched}")
        if batched is None and (res["skipped_forwards"], res["total_forwards"]) != (
                int(mask.sum()), mask.size):
            fail(f"{label}: skipped {res['skipped_forwards']} of {res['total_forwards']}, "
                 f"not skip_mask_for's {int(mask.sum())} of {mask.size}")
        runs += trunk_runs(mask) if count else 0
        done[label] = body
        peaks.append(torch.cuda.max_memory_allocated(dev))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    try:
        # the warmup runs the largest batch the server runs (2 prompts, 4
        # rows), as PipelineServer.warmup does: the peak after it is the one
        # every later request is held to
        for i, body in enumerate(post_concurrent(
                "warmup", [{"prompt": "warmup", "seed": i} for i in (0, 1)])):
            check(f"warmup {i}", body, sched, batched=2, count=i == 0)
        for name, o in overrides.items():
            check(f"sync {name}", post(name, {"prompt": WAN_PROMPT, "seed": 3,
                                              "return_latents": True, **o}), masks[name])
        sub = post("async", {"prompt": SERVE_PROMPTS[0], "seed": 11, "async": True}, 202)
        deadline = time.time() + SERVE_HTTP_S
        while True:
            code, body = http_json("GET", f"{base}/jobs/{sub['job_id']}")
            if code != 200 or body["status"] not in ("queued", "running", "done"):
                fail(f"async job: HTTP {code}, {body}")
            if body["status"] == "done":
                break
            if time.time() > deadline:
                fail("async job: not done in time")
            time.sleep(0.05)
        check("async", body, sched, batched=1)
        for i, body in enumerate(post_concurrent(
                "concurrent", [{"prompt": SERVE_PROMPTS[i], "seed": 21 + i} for i in (0, 1)])):
            check(f"concurrent {i}", body, sched, batched=2, count=i == 0)
        launched = read_counts()
        code_h, health = http_json("GET", base + "/healthz")
        code_i, info = http_json("GET", base + "/info")
    finally:
        httpd.shutdown()
        server.shutdown()
    card = torch.cuda.get_device_name(dev)
    if code_h != 200 or not health["ok"] or health.get("backend") != "cuda" \
            or health.get("device_name") != card:
        fail(f"/healthz {code_h} {health} does not name the card {card!r}")
    if code_i != 200 or info["steps"] != STEPS or not info["overrides_supported"] \
            or info["config"]["size"] != [832, 480]:
        fail(f"/info {code_i}: {info}")
    log(f"  /healthz {health}; /info: {info['pipeline']}, {info['steps']} steps, "
        f"overrides supported")
    # 6 sampler runs: 3 single (the sync requests), 3 batched (the warmup
    # pair and the concurrent pair, 4 rows each; the async job alone)
    heads = 6 * STEPS
    expected = wan_launches(TRUNK_LAUNCHES, runs, heads)
    log(f"  launches of the served requests: {launched} ({runs} trunk runs, a batch one "
        f"a step; K3p {heads})")
    for k, got in launched.items():
        if got != expected[k]:
            fail(f"served requests: {k} launched {got} times, expected {expected[k]}")
    if peaks[-1] > 1.05 * peaks[0]:
        fail(f"peak memory grew from {peaks[0] / 1e9:.2f} GB after the first request to "
             f"{peaks[-1] / 1e9:.2f} GB after the last")
    log(f"  peak memory {peaks[0] / 1e9:.2f} GB after the first request, "
        f"{peaks[-1] / 1e9:.2f} GB after the last")

    # the same requests straight through generate (not counted above)
    direct = {}
    for name, mask in masks.items():
        out = pipe.generate(WAN_PROMPT, seed=3, skip_override=mask)
        served = served_latents(done[f"sync {name}"])
        same = torch.equal(served, out.latents.float().cpu())
        body = done[f"sync {name}"]
        log(f"  sync {name}: wall_s {body['wall_s']} queue_wait_s {body['queue_wait_s']} "
            f"(served generate {body['result']['timings']['total_s']} s; direct generate "
            f"{out.timings['total_s']:.3f} s); {body['result']['skipped_forwards']} of "
            f"{body['result']['total_forwards']} skipped; latents "
            f"{'bit-equal to' if same else 'DIFFER from'} the direct generate's")
        if not same:
            fail(f"sync {name}: served latents differ from generate's at the same seed "
                 f"(rel L2 {rel_l2(served, out.latents):.3e})")
        direct[name] = out
    # a micro-batched element is its single run, bit for bit: its rows take
    # the same kernels and reductions whatever the batch (phase 86's readings
    # on the card, and tests/test_torch_serve.py on the CPU)
    body = done["warmup 0"]
    log(f"  warmup (a micro-batch of 2): wall_s {body['wall_s']} queue_wait_s "
        f"{body['queue_wait_s']} (generate_batch {body['result']['timings']['total_s']} s)")
    lone = next(b for b in batches if b[1] == [11])
    pairs = next(b for b in batches if sorted(b[1]) == [21, 22])
    for label, (prompts, seeds, lat) in (("async", lone), ("concurrent", pairs)):
        for j, (prompt, seed) in enumerate(zip(prompts, seeds)):
            single = pipe.generate(prompt, seed=seed)
            same = torch.equal(lat[j], single.latents[0].float().cpu())
            name = label if len(prompts) == 1 else f"concurrent {seed - 21}"
            body = done[name]
            log(f"  {name} (element {j} of a micro-batch of {len(prompts)}): wall_s "
                f"{body['wall_s']} queue_wait_s {body['queue_wait_s']} (generate_batch "
                f"{body['result']['timings']['total_s']} s for the batch; its single run "
                f"{single.timings['total_s']:.3f} s); "
                f"{'bit-equal to' if same else 'DIFFERS from'} its single run")
            if not bool(torch.isfinite(lat[j]).all()) or not same:
                fail(f"micro-batched {name}: rel L2 {rel_l2(lat[j], single.latents[0]):.3e} "
                     f"from its single run, not bit-equal")
    batch4_kernel_checks(dev, rec)
    serve_cli_subprocess(sched, served_latents(done["sync E012K2R02"]))
    return launched


def phase_sweep(dev, model):
    """Returns the two sweeps' launches."""
    import os
    import shutil

    from magcache_tpu_torch.eval.compare import compare_dirs
    from magcache_tpu_torch.eval.sweep import (DEFAULT_PROMPTS, SweepConfig, run_sweep,
                                               sweep_pipeline_config)
    from magcache_tpu_torch.pipelines.wan import WanPipeline

    log(f"phase 87: run_sweep over DEFAULT_PROMPTS[0:2] at 832x480x17, {STEPS} UniPC steps: "
        f"full compute (one prompt at a time), then MagCache (dp=2: both prompts in one "
        f"generate_batch), then compare_dirs of the MagCache latents against the full ones")
    root = os.path.join(_scratch_dir(), "sweep")
    shutil.rmtree(root, ignore_errors=True)
    launches, dirs, summaries = dict(NO_LAUNCHES), {}, {}
    for variant, dp in (("full", 1), ("magcache", 2)):
        cfg = SweepConfig(variant=variant, dp=dp, end_index=2, size=(832, 480), frame_num=17,
                          sample_steps=STEPS, out_dir=os.path.join(root, variant))
        pipe = WanPipeline(sweep_pipeline_config(cfg), dev, model=model)
        mask = pipe.skip_mask_for(use_magcache=variant == "magcache")
        if variant == "magcache" and not mask.any():
            fail("the sweep's MagCache schedule skips nothing")
        reset_counts()
        summary = run_sweep(cfg, pipeline=pipe)
        launched = read_counts()
        sampler_runs = 2 if dp == 1 else 1
        expected = wan_launches(TRUNK_LAUNCHES, sampler_runs * trunk_runs(mask),
                                sampler_runs * STEPS)
        if launched != expected:
            fail(f"sweep {variant}: launches {launched}, not {expected} (the realized "
                 f"schedule: {trunk_runs(mask)} trunk runs a run)")
        rows = [json.loads(line) for line in open(os.path.join(cfg.out_dir, "manifest.jsonl"))]
        if ([(r["index"], r["seed"], r["variant"], r["prompt"]) for r in rows]
                != [(i, i, variant, DEFAULT_PROMPTS[i]) for i in (0, 1)]):
            fail(f"sweep {variant}: manifest {rows}")
        for i in (0, 1):
            arr = np.load(os.path.join(cfg.out_dir, f"{i:05d}.npy"))
            if arr.shape != (5, 60, 104, 16) or not np.isfinite(arr).all():
                fail(f"sweep {variant}: {i:05d}.npy {arr.shape} not finite or misshapen")
        launches = {k: n + launched[k] for k, n in launches.items()}
        dirs[variant], summaries[variant] = cfg.out_dir, summary
        log(f"  {variant} (dp {dp}): sec_per_video_mean {summary['sec_per_video_mean']:.3f} s, "
            f"sec_total {summary['sec_total']} s; {trunk_runs(mask)} of {STEPS} steps run the "
            f"trunk ({int(mask.sum())} of {mask.size} lane-forwards skipped), launches as "
            f"counted")
    cmp = compare_dirs(dirs["magcache"], dirs["full"], metrics=("psnr", "ssim"))
    mean = cmp["mean"]
    if cmp["count"] != 2 or not all(np.isfinite(v) for v in mean.values()):
        fail(f"compare_dirs: {cmp}")
    log(f"  compare_dirs (MagCache latents against full compute, latent space, random "
        f"weights): PSNR {mean['psnr']:.3f} dB, SSIM {mean['ssim']:.4f} over {cmp['count']} "
        f"videos; sec_per_video_mean full {summaries['full']['sec_per_video_mean']:.3f} s, "
        f"MagCache dp 2 {summaries['magcache']['sec_per_video_mean']:.3f} s")
    return launches


# ------------------------------------------------- published checkpoints (88, 89)
# The port's seeded weights written under the published names (these maps
# invert the package's converters here, so the loaders are checked against
# an independent map), then loaded back through the entry points.
CKPT_UMT5_LAYERS = 24          # UMT5-XXL's full depth
OG_LORA_RANK, OG_LORA_ALPHA, OG_LORA_SCALE = 16, 8.0, 0.75


def wan_published(sd: dict) -> dict:
    """A ``WanModel`` (t2v) state dict under the published Wan2.1 names."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0] == "patch_embedding" and parts[1] == "weight":
            out[k] = v.reshape(v.shape[0], -1, 1, 2, 2)
        elif parts[0] in ("text_embedding", "time_embedding"):
            out[f"{parts[0]}.{'0' if parts[1] == 'in' else '2'}.{parts[2]}"] = v
        elif parts[0] == "time_projection":
            out[f"time_projection.1.{parts[1]}"] = v
        elif parts[0] == "head":
            out["head.modulation" if parts[1] == "modulation" else f"head.head.{parts[2]}"] = (
                v[None] if parts[1] == "modulation" else v)
        elif parts[0] == "blocks":
            b, name = f"blocks.{parts[1]}", parts[2]
            rest = ".".join(parts[3:])
            if name == "modulation":
                out[f"{b}.modulation"] = v[None]
            elif name in ("q", "k", "v", "o"):
                out[f"{b}.self_attn.{name}.{rest}"] = v
            elif name.startswith("cross_") and name[6:] in ("q", "k", "v", "o"):
                out[f"{b}.cross_attn.{name[6:]}.{rest}"] = v
            elif name in ("norm_q", "norm_k"):
                out[f"{b}.self_attn.{name}.weight"] = v
            elif name in ("cross_norm_q", "cross_norm_k"):
                out[f"{b}.cross_attn.{name[6:]}.weight"] = v
            elif name in ("norm3_w", "norm3_b"):
                out[f"{b}.norm3.{'weight' if name[-1] == 'w' else 'bias'}"] = v
            elif name in ("ffn1", "ffn2"):
                out[f"{b}.ffn.{'0' if name == 'ffn1' else '2'}.{rest}"] = v
            else:
                raise KeyError(k)
        else:
            out[k] = v
    return out


def umt5_published(sd: dict) -> dict:
    """A per-layer-bias ``T5Model`` state dict under the wan package's UMT5
    names (``models_t5_umt5-xxl-enc-bf16.pth``)."""
    names = {"ln1": "norm1.weight", "ln2": "norm2.weight", "rel": "pos_embedding.embedding.weight",
             "q.weight": "attn.q.weight", "k.weight": "attn.k.weight",
             "v.weight": "attn.v.weight", "o.weight": "attn.o.weight",
             "wi0.weight": "ffn.gate.0.weight", "wi1.weight": "ffn.fc1.weight",
             "wo.weight": "ffn.fc2.weight"}
    out = {"token_embedding.weight": sd["embed"], "norm.weight": sd["final_ln"]}
    for k, v in sd.items():
        if k.startswith("blocks."):
            _, i, rest = k.split(".", 2)
            out[f"blocks.{i}.{names[rest]}"] = v
    return out


def wan_vae_published(sd: dict, cfg) -> dict:
    """A ``WanVAE`` state dict under ``wan/modules/vae.py``'s names: the
    levels' residual blocks and resamples flattened into
    ``{encoder.downsamples | decoder.upsamples}.N``, the norm gains
    ``[C, 1, 1(, 1)]``."""
    res = {"norm1": ("residual.0.gamma", (1, 1, 1)), "conv1": ("residual.2", None),
           "norm2": ("residual.3.gamma", (1, 1, 1)), "conv2": ("residual.6", None),
           "shortcut": ("shortcut", None)}

    def put(dst, name, v):
        leaf = name.rsplit(".", 1)
        key, shape = res[leaf[0]] if leaf[0] in res else (leaf[0], None)
        if shape is not None:
            out[f"{dst}.{key}"] = v.reshape(-1, *shape)
        else:
            out[f"{dst}.{key}.{leaf[1]}"] = v

    out = {}
    for side, seq, blocks in (("encoder", "downsamples", cfg.num_res_blocks),
                              ("decoder", "upsamples", cfg.num_res_blocks + 1)):
        flat = 0
        for i in range(len(cfg.dim_mult)):
            for j in range(blocks):
                pre = f"{side}.levels.{i}.blocks.{j}."
                for k, v in sd.items():
                    if k.startswith(pre):
                        put(f"{side}.{seq}.{flat}", k[len(pre):], v)
                flat += 1
            if i < len(cfg.dim_mult) - 1:
                for kind, key in (("resample", "resample.1"), ("time_conv", "time_conv")):
                    for leaf in ("weight", "bias"):
                        k = f"{side}.levels.{i}.{kind}.{leaf}"
                        if k in sd:
                            out[f"{side}.{seq}.{flat}.{key}.{leaf}"] = sd[k]
                flat += 1
        for m in (0, 1):
            pre = f"{side}.mid.{m}."
            for k, v in sd.items():
                if k.startswith(pre):
                    put(f"{side}.middle.{2 * m}", k[len(pre):], v)
        out[f"{side}.middle.1.norm.gamma"] = sd[f"{side}.mid_attn.norm"].reshape(-1, 1, 1)
        for ours, theirs in (("qkv", "to_qkv"), ("proj", "proj")):
            for leaf in ("weight", "bias"):
                out[f"{side}.middle.1.{theirs}.{leaf}"] = sd[f"{side}.mid_attn.{ours}.{leaf}"]
        out[f"{side}.head.0.gamma"] = sd[f"{side}.head_norm"].reshape(-1, 1, 1, 1)
        for leaf in ("weight", "bias"):
            out[f"{side}.conv1.{leaf}"] = sd[f"{side}.conv1.{leaf}"]
            out[f"{side}.head.2.{leaf}"] = sd[f"{side}.head.{leaf}"]
            out[f"conv1.{leaf}"] = sd[f"quant.{leaf}"]
            out[f"conv2.{leaf}"] = sd[f"post_quant.{leaf}"]
    return out


OG_GROUPS = {"context_refiner": "context_refiner", "noise_refiner": "noise_refiner",
             "ref_refiner": "ref_image_refiner", "layers": "layers"}


def omnigen2_published(sd: dict, cfg) -> dict:
    """An ``OmniGen2Model`` state dict under the published (Lumina2 lineage)
    names: the fused GQA ``kv`` split back into ``to_k`` / ``to_v``."""
    dk = cfg.kv_heads * cfg.head_dim
    top = {"t_embed.in": "time_caption_embed.timestep_embedder.linear_1",
           "t_embed.out": "time_caption_embed.timestep_embedder.linear_2",
           "cap_proj": "time_caption_embed.caption_embedder.1", "x_embed": "x_embedder",
           "ref_embed": "ref_image_patch_embedder", "norm_out_mod": "norm_out.linear_1",
           "final_out": "norm_out.linear_2"}
    blk = {"q": "attn.to_q", "o": "attn.to_out.0", "w1": "feed_forward.linear_1",
           "w2": "feed_forward.linear_2", "w3": "feed_forward.linear_3", "mod": "norm1.linear",
           "q_norm": "attn.norm_q.weight", "k_norm": "attn.norm_k.weight",
           "norm2": "norm2.weight", "ffn_norm1": "ffn_norm1.weight",
           "ffn_norm2": "ffn_norm2.weight"}
    out = {"time_caption_embed.caption_embedder.0.weight": sd["cap_norm"]}
    for k, v in sd.items():
        head, _, leaf = k.rpartition(".")
        if head in top:
            out[f"{top[head]}.{leaf}"] = v
            continue
        group = k.split(".")[0]
        if group not in OG_GROUPS:
            if k != "cap_norm":
                raise KeyError(k)
            continue
        _, i, rest = k.split(".", 2)
        b = f"{OG_GROUPS[group]}.{i}"
        name, _, leaf = rest.partition(".")
        if name == "kv":
            out[f"{b}.attn.to_k.{leaf}"], out[f"{b}.attn.to_v.{leaf}"] = v[:dk], v[dk:]
        elif name == "norm1":
            modulated = f"{group}.{i}.mod.weight" in sd
            out[f"{b}.norm1.norm.weight" if modulated else f"{b}.norm1.weight"] = v
        elif leaf:
            out[f"{b}.{blk[name]}.{leaf}"] = v
        else:
            out[f"{b}.{blk[name]}"] = v
    return out


def peak_rss_gb() -> float:
    """This process's peak resident set so far, in GB (``ru_maxrss``)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _disk_error(e: OSError, where: str):
    fail(f"{where}: {e} (a lack of disk space fails this phase)")


def phase_wan_checkpoint(dev):
    """Phase 88: Wan2.1 T2V-1.3B from a published-layout directory through
    the CLI's pipeline builder (``--ckpt_dir`` with the DiT in two BF16
    safetensors shards and the UMT5-XXL ``.pth``; ``--vae_ckpt``), held bit
    for bit to the seeded in-process pipeline. Returns the launches of the
    loaded pipeline's request."""
    import gc
    import shutil
    import tempfile

    from magcache_tpu_torch.cli import generate as G
    from magcache_tpu_torch.models.checkpoint import save_safetensors
    from magcache_tpu_torch.models.text import FallbackHashTokenizer
    from magcache_tpu_torch.models.umt5 import UMT5_XXL, UMT5Encoder
    from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE
    from magcache_tpu_torch.pipelines.wan import WanPipeline, WanPipelineConfig

    bf16 = torch.bfloat16
    ucfg = dataclasses.replace(UMT5_XXL, layers=CKPT_UMT5_LAYERS)
    log(f"phase 88: Wan2.1 T2V-1.3B from a published checkpoint directory (DiT in 2 BF16 "
        f"safetensors shards, UMT5-XXL {ucfg.layers} of 24 layers as a BF16 .pth, the VAE "
        f"as an f32 .pth) through the CLI's --ckpt_dir / --vae_ckpt; a request at "
        f"832x480x17, {STEPS} steps, E012K2R02")
    t_all = time.time()
    model = make_model(dev)
    with torch.no_grad():           # the seeded weights as BF16 files hold them
        for p in model.parameters():
            p.copy_(p.to(bf16))
    enc = UMT5Encoder(ucfg, seq_len=512, device=dev,
                      tokenizer=FallbackHashTokenizer(ucfg.vocab_size, eos_token_id=1,
                                                      pad_token_id=0),
                      generator=torch.Generator(device=dev).manual_seed(31))
    with torch.no_grad():
        for p in enc.model.parameters():
            p.copy_(p.to(bf16))
    vae = WanVAE(WAN21_VAE, dev).init(torch.Generator(device=dev).manual_seed(0))
    vae.requires_grad_(False)
    base = dict(size=(832, 480), frame_num=17, sample_steps=STEPS, sample_shift=5.0,
                guide_scale=5.0, use_magcache=True)
    pipe = WanPipeline(WanPipelineConfig(**base), dev, model=model, text_encoder=enc, vae=vae)
    want = pipe.generate(WAN_PROMPT, seed=3)
    want_lat, want_video = want.latents.cpu(), want.video.cpu()
    log(f"  in-process request: {want.timings['total_s']:.3f} s, skips per lane "
        f"{want.skips.sum(0).tolist()}")

    tmp = tempfile.mkdtemp(prefix="wan_ckpt_")
    try:
        t0 = time.time()
        try:
            dit = {k: v.to(bf16) for k, v in wan_published(model.state_dict()).items()}
            keys = sorted(dit)
            for n, part in enumerate((keys[:len(keys) // 2], keys[len(keys) // 2:])):
                save_safetensors(
                    {k: dit[k] for k in part},
                    f"{tmp}/diffusion_pytorch_model-0000{n + 1}-of-00002.safetensors")
            t5 = {k: v.to(bf16).cpu() for k, v in umt5_published(enc.model.state_dict()).items()}
            torch.save(t5, f"{tmp}/models_t5_umt5-xxl-enc-bf16.pth")
            vsd = {k: v.cpu() for k, v in wan_vae_published(vae.state_dict(), WAN21_VAE).items()}
            torch.save(vsd, f"{tmp}/Wan2.1_VAE.pth")
        except OSError as e:
            _disk_error(e, "phase 88, writing the checkpoint")
        files = sorted(os.listdir(tmp))
        written = sum(os.path.getsize(f"{tmp}/{f}") for f in files)
        log(f"  wrote {len(files)} files, {written / 1e9:.3f} GB in {time.time() - t0:.1f} s "
            f"({', '.join(files)}); peak RSS {peak_rss_gb():.1f} GB")
        ref_sd = {k: v.clone() for k, v in model.state_dict().items()}
        del pipe, enc, model, dit
        gc.collect()
        torch.cuda.empty_cache()

        args = G.build_parser().parse_args(
            ["--task", "t2v-1.3B", "--ckpt_dir", tmp, "--vae_ckpt", f"{tmp}/Wan2.1_VAE.pth",
             "--size", "832*480", "--frame_num", "17", "--sample_steps", str(STEPS),
             "--use_magcache", "--device", "cuda"])
        t0 = time.time()
        loaded, _, _ = G._pipeline(args)
        G._attach_vae(args, loaded)
        torch.cuda.synchronize(dev)
        log(f"  loaded through the CLI's pipeline builder in {time.time() - t0:.1f} s; peak "
            f"RSS {peak_rss_gb():.1f} GB; {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB "
            f"on the card")
        got_sd = loaded.model.state_dict()
        bad = [k for k in ref_sd if got_sd[k].dtype != ref_sd[k].dtype
               or not torch.equal(got_sd[k], ref_sd[k])]
        if got_sd.keys() != ref_sd.keys() or bad:
            fail(f"phase 88: the loaded DiT differs from the seeded one in {bad[:3]}")
        t5_sd = umt5_published(loaded.text_encoder.model.state_dict())
        bad = [k for k in t5 if not torch.equal(t5_sd[k].cpu(), t5[k].float())]
        if t5_sd.keys() != t5.keys() or bad:
            fail(f"phase 88: the loaded UMT5 differs from the written one in {bad[:3]}")
        v_sd = wan_vae_published(loaded.vae.state_dict(), loaded.vae.cfg)
        if loaded.vae.cfg != WAN21_VAE or any(not torch.equal(v_sd[k].cpu(), vsd[k])
                                              for k in vsd):
            fail(f"phase 88: the loaded VAE ({loaded.vae.cfg}) differs from the seeded one")
        log(f"  DiT ({len(ref_sd)} tensors), UMT5 ({len(t5)}) and VAE ({len(vsd)}, sniffed "
            f"config = WAN21_VAE) bit-equal to the seeded weights")
        del t5, vsd
        reset_counts()
        got = loaded.generate(WAN_PROMPT, seed=3)
        counts = read_counts()
        runs = int((~got.skips.all(1)).sum())
        expected = wan_launches(TRUNK_LAUNCHES, runs, STEPS)
        if counts != expected:
            fail(f"phase 88: launches {counts} != {expected} ({runs} trunk runs)")
        if not np.array_equal(got.skips, want.skips):
            fail("phase 88: the loaded pipeline skipped other forwards")
        if not torch.equal(got.latents.cpu(), want_lat):
            fail(f"phase 88: latents differ from the seeded pipeline's (max |diff| "
                 f"{float((got.latents.cpu() - want_lat).abs().max()):.3e})")
        video = got.video
        if (tuple(video.shape) != (1, 17, 480, 832, 3) or not bool(torch.isfinite(video).all())
                or not torch.equal(video.cpu(), want_video)):
            fail(f"phase 88: pixels {tuple(video.shape)} not finite, misshapen or not the "
                 f"seeded pipeline's")
        log(f"  loaded request: {got.timings['total_s']:.3f} s (decode "
            f"{got.timings['decode_s']:.3f} s), latents and pixels bit-equal to the seeded "
            f"pipeline's, pixels finite; launches {counts} ({runs} trunk runs)")
        del loaded, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 88: {time.time() - t_all:.1f} s; peak RSS {peak_rss_gb():.1f} GB")
    return counts


def phase_omnigen2_lora(dev):
    """Phase 89: OmniGen2 (3.012 B) from a checkpoint directory with a
    ``config.json``: the sniffed configuration; a rank-16 PEFT adapter with
    alpha on the attention projections merged by ``lora_path``, held to the
    formula on the card; a t2i forward at 1024x1024 equal to one of the same
    merged weights built in-process. Returns its launches."""
    import gc
    import shutil
    import tempfile

    from magcache_tpu_torch.models.checkpoint import save_safetensors
    from magcache_tpu_torch.models.omnigen2 import OmniGen2Model, make_omnigen2_core
    from magcache_tpu_torch.models.published import load_omnigen2_checkpoint
    from magcache_tpu_torch.models.text import MockTextEncoder
    from magcache_tpu_torch.pipelines.omnigen2 import OmniGen2Pipeline, OmniGen2PipelineConfig

    log(f"phase 89: OmniGen2 from a checkpoint directory with config.json, a PEFT adapter "
        f"(rank {OG_LORA_RANK}, alpha {OG_LORA_ALPHA}, scale {OG_LORA_SCALE}) on the "
        f"attention projections, a t2i forward at 1024x1024")
    t_all = time.time()
    model = make_omnigen2_model(dev)
    cfg = model.cfg
    pub = omnigen2_published(model.state_dict(), cfg)
    gen = torch.Generator(device=dev).manual_seed(89)
    adapter, targets = {}, []
    for group, depth in (("layers", cfg.layers), ("noise_refiner", cfg.refiner_layers)):
        for i in range(depth):
            for proj in ("to_q", "to_k", "to_v", "to_out.0"):
                base = f"{group}.{i}.attn.{proj}"
                out_dim, in_dim = pub[f"{base}.weight"].shape
                adapter[f"transformer.{base}.lora_A.weight"] = torch.randn(
                    (OG_LORA_RANK, in_dim), generator=gen, device=dev) * 0.02
                adapter[f"transformer.{base}.lora_B.weight"] = torch.randn(
                    (out_dim, OG_LORA_RANK), generator=gen, device=dev) * 0.02
                adapter[f"transformer.{base}.alpha"] = torch.tensor(OG_LORA_ALPHA)
                targets.append(base)
    tmp = tempfile.mkdtemp(prefix="omnigen2_ckpt_")
    try:
        t0 = time.time()
        try:
            written = save_safetensors(pub, f"{tmp}/diffusion_pytorch_model.safetensors")
            written += save_safetensors(adapter, f"{tmp}/adapter.safetensors")
            with open(f"{tmp}/config.json", "w") as f:
                json.dump({"hidden_size": cfg.hidden, "num_attention_heads": cfg.heads,
                           "num_kv_heads": cfg.kv_heads, "num_layers": cfg.layers,
                           "num_refiner_layers": cfg.refiner_layers,
                           "in_channels": cfg.in_channels, "patch_size": cfg.patch,
                           "text_feat_dim": cfg.text_dim, "axes_dim_rope": list(cfg.axes_dims),
                           "norm_eps": cfg.eps}, f)
        except OSError as e:
            _disk_error(e, "phase 89, writing the checkpoint")
        log(f"  wrote {written / 1e9:.3f} GB ({len(pub)} tensors, {len(targets)} adapted "
            f"projections) in {time.time() - t0:.1f} s")
        t0 = time.time()
        _, sniffed = load_omnigen2_checkpoint(tmp, dtype=cfg.dtype)
        if (sniffed.ffn_dim != cfg.ffn_dim
                or dataclasses.replace(sniffed, ffn_dim_override=None) != cfg):
            fail(f"phase 89: the sniffed config {sniffed} != the in-process {cfg}")
        log(f"  sniffed config = the in-process one ({time.time() - t0:.1f} s)")

        # the formula on the card, on the port's names (kv fuses to_k / to_v)
        eff = OG_LORA_SCALE * OG_LORA_ALPHA / OG_LORA_RANK
        merged = {k: v.clone() for k, v in model.state_dict().items()}
        dk = cfg.kv_heads * cfg.head_dim
        for base in targets:
            group, i, _, proj = base.split(".", 3)
            ours = {"noise_refiner": "noise_refiner", "layers": "layers"}[group]
            w = pub[f"{base}.weight"]
            a = adapter[f"transformer.{base}.lora_A.weight"]
            b = adapter[f"transformer.{base}.lora_B.weight"]
            new = (w.float() + eff * (b @ a)).to(w.dtype)
            if proj in ("to_k", "to_v"):
                rows = slice(0, dk) if proj == "to_k" else slice(dk, 2 * dk)
                merged[f"{ours}.{i}.kv.weight"][rows] = new
            else:
                merged[f"{ours}.{i}.{'q' if proj == 'to_q' else 'o'}.weight"] = new
        del model
        torch.cuda.empty_cache()
        t0 = time.time()
        pipe = OmniGen2Pipeline(OmniGen2PipelineConfig(
            height=OG_SIZE, width=OG_SIZE, txt_len=OG_TXT, dtype=cfg.dtype, ckpt_dir=tmp,
            lora_path=f"{tmp}/adapter.safetensors", lora_scale=OG_LORA_SCALE), dev)
        torch.cuda.synchronize(dev)
        log(f"  OmniGen2Pipeline(ckpt_dir, lora_path) built in {time.time() - t0:.1f} s; "
            f"peak RSS {peak_rss_gb():.1f} GB")
        got_sd = pipe.model.state_dict()
        bad = [k for k in merged if got_sd[k].dtype != merged[k].dtype
               or not torch.equal(got_sd[k], merged[k])]
        if got_sd.keys() != merged.keys() or bad:
            fail(f"phase 89: the merged weights differ from W + scale (alpha / r) B A in "
                 f"{len(bad)} tensors, e.g. {bad[:3]}")
        log(f"  every weight bit-equal to the formula's (f32 on the card, rounded to "
            f"{cfg.dtype}): {len(targets)} adapted, {len(merged)} tensors")
        ref = OmniGen2Model(cfg, dev)
        ref.load_state_dict(merged)
        ref.requires_grad_(False)
        del merged
        txt = MockTextEncoder(OG_TXT, cfg.text_dim, scale=0.5)([OG_PROMPT, "blurry"], device=dev)
        x = torch.randn((2, 128, 128, 16), generator=gen, device=dev)
        t = torch.full((2,), 900.0, device=dev)
        outs = []
        for m in (ref, pipe.model):
            core = make_omnigen2_core(m, OG_TXT, OG_GRID, 0)
            reset_counts()
            hidden, c = core.prepare(x, t, {"txt": txt})
            outs.append(core.head(core.trunk(hidden, c), c))
            counts = read_counts()
            check_og_launches("phase 89 t2i forward", counts, OG_TRUNK + OG_REFINER)
        if not bool(torch.isfinite(outs[1]).all()) or not torch.equal(outs[0], outs[1]):
            fail(f"phase 89: the loaded forward differs from the in-process one (max |diff| "
                 f"{float((outs[0] - outs[1]).abs().max()):.3e})")
        log(f"  t2i forward {tuple(outs[1].shape)} bit-equal to the in-process merged "
            f"model's, finite; K1 {counts['flash_attention_bshd']} a forward")
        del pipe, ref, outs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 89: {time.time() - t_all:.1f} s; peak RSS {peak_rss_gb():.1f} GB")
    return counts


def main():
    phase_environment()
    dev = torch.device("cuda", 0)
    t0 = time.time()
    phase_build(dev)
    rec = {}                 # kernel name -> its result for the JSON line
    phase_kernels(dev, rec)
    log("phase 4/5 model:")
    model = make_model(dev)
    single_forward = phase_forward(dev, model)
    launches, single_latents, sched = phase_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    narrow_cpu = phase_card_vs_cpu(dev)
    t_wan = time.time() - t0
    phase_os_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 8/9 model:")
    model = make_os_model(dev)
    phase_os_forward(dev, model)
    os_launches, os_full = phase_os_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_os_card_vs_cpu(dev)
    t_os = time.time() - t0 - t_wan
    phase_flux_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 12/13 model:")
    model = make_flux_model(dev)
    phase_flux_forward(dev, model)
    flux_launches = phase_flux_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_flux_card_vs_cpu(dev)
    t_flux = time.time() - t0 - t_wan - t_os
    phase_os720_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 16/17 model:")
    model = make_os_model(dev)
    phase_os720_forward(dev, model)
    os720_launches = phase_os720_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_os720_card_vs_cpu(dev)
    t_os720 = time.time() - t0 - t_wan - t_os - t_flux
    phase_latte_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 20/21 model:")
    model = make_latte_model(dev)
    latte_vpu = phase_latte_forward(dev, model)
    latte, latte_grouped, latte_full = phase_latte_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_latte_card_vs_cpu(dev)
    t_latte = time.time() - t0 - t_wan - t_os - t_flux - t_os720
    phase_sp_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 24/25 model:")
    model = make_model(dev)          # the same seed: phase 4's and 5's weights
    phase_sp_forward(dev, model, single_forward)
    sp_ulysses, sp_ring = phase_sp_requests(dev, model, single_latents, sched)
    del model, single_forward
    torch.cuda.empty_cache()
    phase_sp_card_vs_cpu(dev, narrow_cpu)
    t_sp = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte
    phase_os_unpacked_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 28/29 model:")
    model = make_os_model(dev)       # the same seed: phase 8's weights
    os_unpacked = phase_os_unpacked_forward(dev, model)
    os_unpacked["grouped"] = phase_os_unpacked_request(dev, model, os_unpacked["grouped"])
    del model
    torch.cuda.empty_cache()
    os_noqk = phase_os_noqknorm(dev)
    t_unpacked = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp
    umt5 = phase_umt5(dev)
    vae = phase_vae_decode(dev)
    wan_video = phase_wan_video(dev, umt5, vae)
    del umt5, vae
    torch.cuda.empty_cache()
    t_ends = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp - t_unpacked
    log("phase 34/35 model:")
    model = make_model(dev)          # the same seed: phase 5's weights
    wan_solvers = phase_wan_solvers(dev, model, single_latents["full compute"])
    wan_tea = phase_wan_teacache(dev, model)
    del model
    torch.cuda.empty_cache()
    log("phase 36 model:")
    model = make_os_model(dev)       # the same seed: phase 9's weights
    os_pab, os_rolling = phase_os_pab(dev, rec, model, os_full)
    del model
    torch.cuda.empty_cache()
    log("phase 37 model:")
    model = make_latte_model(dev)    # the same seed: phase 21's weights
    latte_pab = phase_latte_pab(dev, model, latte_full)
    del model
    torch.cuda.empty_cache()
    phase_narrow_new_paths(dev)
    t_pab = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp \
        - t_unpacked - t_ends
    phase_osp_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 40/41 model:")
    model = make_osp_model(dev)
    osp = phase_osp_forward(dev, model)
    reqs = phase_osp_requests(dev, model)
    osp = {k: n + reqs[k] for k, n in osp.items()}
    del model
    torch.cuda.empty_cache()
    log("phase 42 model:")
    osp_v110 = phase_v110_requests(dev)
    torch.cuda.empty_cache()
    log("phase 43/44 model:")
    model = make_cogvideox_model(dev)
    cog = phase_cogvideox_forward(dev, rec, model)
    reqs = phase_cogvideox_requests(dev, model)
    cog = {k: n + reqs[k] for k, n in cog.items()}
    del model
    torch.cuda.empty_cache()
    phase_osp_cogvideox_card_vs_cpu(dev)
    t_osp = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp \
        - t_unpacked - t_ends - t_pab
    phase_vchitect_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 47/48 model:")
    model = make_vchitect_model(dev)
    vch = phase_vchitect_forward(dev, model)
    reqs = phase_vchitect_requests(dev, model)
    vch = {k: n + reqs[k] for k, n in vch.items()}
    del model
    torch.cuda.empty_cache()
    osp_vae, cog_vae = phase_vae_decodes(dev)
    torch.cuda.empty_cache()
    t0_text = time.time()
    mt5 = phase_mt5(dev)
    t_text = time.time() - t0_text
    osp_px, cog_px = phase_pixel_requests(dev, osp_vae, cog_vae, mt5)
    del mt5
    torch.cuda.empty_cache()
    phase_vchitect_vae_card_vs_cpu(dev, osp_vae, cog_vae)
    del osp_vae, cog_vae
    torch.cuda.empty_cache()
    t_vch = time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp \
        - t_unpacked - t_ends - t_pab - t_osp
    vaes = phase_sd_vae_decodes(dev)
    t0_text = time.time()
    t5s, clip_l, sd3 = phase_text_encoders(dev)
    t_text += time.time() - t0_text
    pixel_paths = phase_pixel_families(dev, vaes, t5s, clip_l, sd3)
    del vaes, t5s, clip_l, sd3
    torch.cuda.empty_cache()
    phase_vae_card_vs_cpu(dev)
    t0_text = time.time()
    phase_text_card_vs_cpu(dev)
    t_text += time.time() - t0_text
    t0_i2v = time.time()
    phase_i2v_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 59/60 model:")
    model = make_i2v_model(dev)
    i2v = phase_i2v_forward(dev, model)
    text, clip, vae = i2v_encoders(dev)
    reqs = phase_i2v_requests(dev, model, text, clip, vae)
    i2v = {k: n + reqs[k] for k, n in i2v.items()}
    del model
    torch.cuda.empty_cache()
    flf2v = phase_flf2v_request(dev, text, clip, vae)
    del text, clip, vae
    torch.cuda.empty_cache()
    phase_i2v_card_vs_cpu(dev)
    t_i2v = time.time() - t0_i2v
    from magcache_tpu_torch.models.vae_wan import WAN21_VAE, WanVAE
    from magcache_tpu_torch.models.wan import WAN_5B

    t0_w22 = time.time()
    phase_wan22_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 64/65 model:")
    model = make_wan_model(dev, dataclasses.replace(WAN_5B, dtype="bfloat16"), "TI2V-5B")
    ti2v = phase_ti2v_forward(dev, model)
    reqs = phase_ti2v_request(dev, model)
    ti2v = {k: n + reqs[k] for k, n in ti2v.items()}
    del model
    torch.cuda.empty_cache()
    vace = phase_vace14_forward(dev)
    vae = WanVAE(WAN21_VAE, dev).init(torch.Generator(device=dev).manual_seed(67))
    reqs = phase_vace_requests(dev, vae.requires_grad_(False))
    vace = {k: n + reqs[k] for k, n in vace.items()}
    a14b = phase_a14b_requests(dev, vae)
    del vae
    torch.cuda.empty_cache()
    phase_wan22_card_vs_cpu(dev)
    t_w22 = time.time() - t0_w22
    t0_hy = time.time()
    phase_hunyuan_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 71-74 model:")
    model = make_hunyuan_model(dev)
    hunyuan = phase_hunyuan_forward(dev, model)
    reqs = phase_hunyuan_request(dev, model)
    hunyuan = {k: n + reqs[k] for k, n in hunyuan.items()}
    framepack = phase_framepack_requests(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_hunyuan_card_vs_cpu(dev)
    t_hy = time.time() - t0_hy
    t0_qi = time.time()
    phase_qwen_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 77-79 model:")
    model = make_qwen_model(dev)
    qi = phase_qwen_forward(dev, model)
    ref = qwen_edit_reference(dev, model)
    reqs, text = phase_qwen_request(dev, model)
    qwen = {k: n + reqs[k] for k, n in qi["t2i"].items()}
    reqs = phase_qwen_edit_request(dev, model, text, ref)
    qwen_edit = {k: n + reqs[k] for k, n in qi["edit"].items()}
    del model, text
    torch.cuda.empty_cache()
    phase_qwen_card_vs_cpu(dev)
    t_qi = time.time() - t0_qi
    t0_og = time.time()
    phase_omnigen2_kernels(dev, rec)
    torch.cuda.empty_cache()
    log("phase 82-84 model:")
    model = make_omnigen2_model(dev)
    og = phase_omnigen2_forward(dev, model)
    reqs = phase_omnigen2_requests(dev, model)
    og = {mode: {k: n + reqs[mode][k] for k, n in og[mode].items()} for mode in og}
    reqs = phase_omnigen2_policies(dev, model)
    og["edit"] = {k: n + reqs[k] for k, n in og["edit"].items()}
    del model
    torch.cuda.empty_cache()
    phase_omnigen2_card_vs_cpu(dev)
    t_og = time.time() - t0_og
    t0_serve = time.time()
    log("phase 86/87 model:")
    model = make_model(dev)          # the same seed: phase 5's weights
    serve = phase_serve(dev, model, rec)
    sweep = phase_sweep(dev, model)
    del model
    torch.cuda.empty_cache()
    t_serve = time.time() - t0_serve
    t0_ckpt = time.time()
    wan_ckpt = phase_wan_checkpoint(dev)
    og_lora = phase_omnigen2_lora(dev)
    t_ckpt = time.time() - t0_ckpt
    log(f"all phases passed in {time.time() - t0:.1f} s (Wan {t_wan:.1f} s, "
        f"Open-Sora {t_os:.1f} s, FLUX {t_flux:.1f} s, Open-Sora 720p "
        f"{t_os720:.1f} s, Latte {t_latte:.1f} s, Wan sequence-parallel {t_sp:.1f} s, "
        f"Open-Sora unpacked and without qk-norm {t_unpacked:.1f} s, UMT5, VAE and "
        f"the Wan video {t_ends:.1f} s, the new solvers, policies and PAB "
        f"{t_pab:.1f} s, Open-Sora-Plan and CogVideoX {t_osp:.1f} s, Vchitect and the "
        f"Open-Sora-Plan and CogVideoX VAEs {t_vch:.1f} s, the SD and Open-Sora VAEs "
        f"and the requests ending in their pixels "
        f"{time.time() - t0 - t_wan - t_os - t_flux - t_os720 - t_latte - t_sp - t_unpacked - t_ends - t_pab - t_osp - t_vch - t_i2v - t_w22 - t_hy - t_qi - t_og - t_serve - t_ckpt:.1f} s; "
        f"the text encoders' phases 55-57, within those, {t_text:.1f} s; Wan I2V-14B and "
        f"FLF2V-14B, phases 58-62, {t_i2v:.1f} s; Wan2.2 TI2V-5B, VACE and the A14B MoE, "
        f"phases 63-69, {t_w22:.1f} s; HunyuanVideo and FramePack, phases 70-75, "
        f"{t_hy:.1f} s; Qwen-Image and Qwen-Image-Edit, phases 76-80, {t_qi:.1f} s; "
        f"OmniGen2, phases 81-85, {t_og:.1f} s; serving and the sweep, phases 86-87, "
        f"{t_serve:.1f} s; published checkpoints and LoRA, phases 88-89, {t_ckpt:.1f} s)")

    meta = {
        "flash_attention_bshd": ("cuda", "magcache_tpu_torch/csrc/hopper_attention.cuh",
                                 "magcache_tpu/ops/attention.py:430"),
        "flash_attention_bshd_qknorm": ("cuda", "magcache_tpu_torch/csrc/flash_attention.cu",
                                        "magcache_tpu/ops/attention.py:381"),
        "flash_attention_bhsd": ("cuda", "magcache_tpu_torch/csrc/hopper_attention.cuh",
                                 "magcache_tpu/ops/attention.py:193"),
        "flash_attention_bhsd_aux": ("cuda", "magcache_tpu_torch/csrc/hopper_attention.cuh",
                                     "magcache_tpu/ops/attention.py:1059"),
        "rms_norm_rope": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                          "magcache_tpu/ops/fused_prologue.py:342"),
        "rms_norm_rope_head": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                               "magcache_tpu/ops/fused_prologue.py:342"),
        "layer_norm_mod": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                           "magcache_tpu/ops/fused_prologue.py:440"),
        "layer_norm_mod_plain": ("triton", "magcache_tpu_torch/csrc/prologue_triton.py",
                                 "magcache_tpu/ops/fused_prologue.py:440"),
        "grouped_attention_fused_qkv": ("cuda", "magcache_tpu_torch/csrc/grouped_attention.cu",
                                        "magcache_tpu/ops/attention.py:755"),
        "grouped_attention_fused_qkv_rowmax": (
            "cuda", "magcache_tpu_torch/csrc/hopper_attention.cuh",
            "magcache_tpu/ops/attention.py:755"),
        "grouped_flash_attention_bshd": ("cuda", "magcache_tpu_torch/csrc/grouped_attention.cu",
                                         "magcache_tpu/ops/attention.py:641"),
        "tiny_temporal_attention": ("cuda", "magcache_tpu_torch/csrc/tiny_attention.cu",
                                    "magcache_tpu/ops/tiny_attention.py:185"),
        "fused_cross_attention": ("cuda", "magcache_tpu_torch/csrc/stdit3_kernels.cu",
                                  "magcache_tpu/ops/attention.py:933"),
        "fused_cross_attention_bias": ("cuda", "magcache_tpu_torch/csrc/stdit3_kernels.cu",
                                       "magcache_tpu/ops/attention.py:933"),
        "lnmod_matmul": ("cuda", "magcache_tpu_torch/csrc/hopper_gemm.cuh",
                         "magcache_tpu/ops/fused_prologue.py:205"),
        "matmul_gated_residual": ("cuda", "magcache_tpu_torch/csrc/hopper_gemm.cuh",
                                  "magcache_tpu/ops/fused_prologue.py:66"),
    }
    paths = {"wan": launches, "open-sora": os_launches, "flux": flux_launches,
             "open-sora-720p": os720_launches, "latte": latte,
             "latte-grouped": latte_grouped, "latte-vpu": latte_vpu,
             "wan-ulysses": sp_ulysses, "wan-ring": sp_ring,
             "open-sora-grouped": os_unpacked["grouped"], "open-sora-vpu": os_unpacked["vpu"],
             "open-sora-noqknorm": os_noqk, "wan-video": wan_video,
             "wan-solvers": wan_solvers, "wan-teacache": wan_tea, "open-sora-pab": os_pab,
             "open-sora-rolling": os_rolling, "latte-pab": latte_pab,
             "open-sora-plan": osp, "open-sora-plan-v110": osp_v110, "cogvideox": cog,
             "vchitect": vch, "open-sora-plan-pixels": osp_px, "cogvideox-pixels": cog_px,
             **pixel_paths, "wan-i2v": i2v, "wan-flf2v": flf2v, "wan-ti2v": ti2v,
             "wan-vace": vace, "wan-a14b": a14b, "hunyuan": hunyuan,
             "framepack": framepack["framepack"], "framepack-f1": framepack["framepack-f1"],
             "qwen-image": qwen, "qwen-image-edit": qwen_edit, "omnigen2": og["t2i"],
             "omnigen2-edit": og["edit"], "wan-serve": serve, "wan-sweep": sweep,
             "wan-ckpt": wan_ckpt, "omnigen2-lora": og_lora}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        by_path = {p: c[name] for p, c in paths.items()}
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": sum(by_path.values()),
                        "launches_by_path": by_path, **rec[name]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
