"""Default configuration tree.

Key for key the schema of ``segmentron_tpu/config/settings.py``, with
the same defaults, so every ``configs/*.yaml`` loads unchanged. The
``TPU`` block is read as it is:

- ``COMPUTE_DTYPE`` is the inference dtype of the weights and
  activations (float32 | bfloat16); ``FUSED_STEM`` routes the
  Xception entry through the entry-chain kernels
  (``ops/entrychain.py``) as in the JAX package.
- ``STEM_WBLOCK`` and ``DW_SHIFT`` name exact reformulations of plain
  convolutions for the TPU; PyTorch computes the same math, so they
  have no effect here.
- ``USE_PALLAS`` routes the spatial attention of DANet and OCNet
  (``ops/attention.py::spatial_attention``) through the flash-attention
  kernel where P >= 2048 positions, as in the JAX package.
- ``USE_PALLAS_SEPCONV`` routes the admitted separable convs through
  the fused kernel (``ops/sepconv.py``); ``INT8_ACTIVATIONS="pw"`` with
  ``INT8_K`` is the int8 serving mode of the separable convs
  (``ops/quant.py``), in which ``FUSED_SEPCONV_V3``, ``FUSED_ENTRY_V3``
  and ``FUSED_SEPCONV_MIN_BYTES`` run whole Xception blocks as chains
  of the fused kernel, all gated as in the JAX package.
- ``INT8_ACTIVATIONS`` ``True``/"full", ``INT8_RESNET`` and calibration
  (``INT8_CALIBRATE``, ``INT8_CALIBRATION_BATCHES > 0``) are not ported
  yet: a model or an evaluator built with one of them set raises
  ``NotImplementedError``.
- Training (``solver/``, ``engine/steps.py::make_train_step``) reads
  ``SOLVER.OPTIMIZER``, ``LR``, ``MOMENTUM``, ``WEIGHT_DECAY``,
  ``EPSILON``, ``DECODER_LR_FACTOR``, ``LR_SCHEDULER`` with ``POLY``,
  ``STEP`` and ``WARMUP``, ``OHEM`` with its threshold and ``min_kept``,
  ``AUX_WEIGHT`` and ``LOSS_NAME`` (mixed CE and OHEM are ported; focal,
  lovasz and dice raise), ``MODEL.MULTI_LOSS_WEIGHT``, ``TRAIN.EPOCHS``
  (the schedule's length), ``SEED`` (the dropout generator) and
  ``TPU.REMAT``, of which only "none" is ported ("dots" and "full"
  raise). ``SOLVER.AUX`` is read by the models (their aux outputs).
- The other ``TRAIN`` keys (batch, crop, paths, checkpointing), the
  mesh, pipeline and TPU compiler keys are accepted and not read: the
  trainer, its data transforms and checkpointing are not ported yet.
"""

import time

from .config import SegmentronConfig

cfg = SegmentronConfig()

# ---------------------------------------------------------------- global
cfg.SEED = 1024
cfg.TIME_STAMP = time.strftime("%Y-%m-%d-%H-%M", time.localtime())
cfg.ROOT_PATH = ""
cfg.PHASE = "train"  # train | test | visual

# ---------------------------------------------------------------- dataset
cfg.DATASET = SegmentronConfig()
cfg.DATASET.NAME = ""
cfg.DATASET.MEAN = [0.485, 0.456, 0.406]
cfg.DATASET.STD = [0.229, 0.224, 0.225]
cfg.DATASET.IGNORE_INDEX = -1
cfg.DATASET.WORKERS = 4
cfg.DATASET.DECODED_CACHE = ""
cfg.DATASET.MODE = "testval"  # val-time transform mode: val | testval
cfg.DATASET.DEVICE_CANVAS = ()

# ---------------------------------------------------------------- train
cfg.TRAIN = SegmentronConfig()
cfg.TRAIN.EPOCHS = 30
cfg.TRAIN.BATCH_SIZE = 1
cfg.TRAIN.CROP_SIZE = 769
cfg.TRAIN.BASE_SIZE = 1024
cfg.TRAIN.MODEL_SAVE_DIR = "runs/checkpoints/"
cfg.TRAIN.LOG_SAVE_DIR = "runs/logs/"
cfg.TRAIN.PRETRAINED_MODEL_PATH = ""
cfg.TRAIN.BACKBONE_PRETRAINED = True
cfg.TRAIN.BACKBONE_PRETRAINED_PATH = ""
cfg.TRAIN.RESUME_MODEL_PATH = ""
cfg.TRAIN.SYNC_BATCH_NORM = True
cfg.TRAIN.SNAPSHOT_EPOCH = 1
cfg.TRAIN.APEX = False

# ---------------------------------------------------------------- solver
cfg.SOLVER = SegmentronConfig()
cfg.SOLVER.LR = 1e-4
cfg.SOLVER.OPTIMIZER = "sgd"  # sgd | adam | adamw
cfg.SOLVER.EPSILON = 1e-8
cfg.SOLVER.MOMENTUM = 0.9
cfg.SOLVER.WEIGHT_DECAY = 1e-4
cfg.SOLVER.DECODER_LR_FACTOR = 10.0
cfg.SOLVER.LR_SCHEDULER = "poly"  # poly | cosine | step
cfg.SOLVER.POLY = SegmentronConfig()
cfg.SOLVER.POLY.POWER = 0.9
cfg.SOLVER.STEP = SegmentronConfig()
cfg.SOLVER.STEP.GAMMA = 0.1
cfg.SOLVER.STEP.DECAY_EPOCH = [10, 20]
cfg.SOLVER.WARMUP = SegmentronConfig()
cfg.SOLVER.WARMUP.EPOCHS = 0.0
cfg.SOLVER.WARMUP.FACTOR = 1.0 / 3
cfg.SOLVER.WARMUP.METHOD = "linear"  # linear | constant
cfg.SOLVER.OHEM = False
cfg.SOLVER.OHEM_THRESH = 0.7
cfg.SOLVER.OHEM_MIN_KEPT = 100000
cfg.SOLVER.AUX = False
cfg.SOLVER.AUX_WEIGHT = 0.4
cfg.SOLVER.LOSS_NAME = ""  # '' -> CE; focal | lovasz | dice | binary_dice

# ---------------------------------------------------------------- test
cfg.TEST = SegmentronConfig()
cfg.TEST.TEST_MODEL_PATH = ""
cfg.TEST.USE_BEST = False
cfg.TEST.BATCH_SIZE = 1
cfg.TEST.CROP_SIZE = None  # sliding-window window size; None = whole image
cfg.TEST.SCALES = [1.0]  # multi-scale TTA factors
cfg.TEST.FLIP = False  # horizontal-flip TTA
cfg.TEST.DISTRIBUTED = True  # data-parallel eval when several devices
cfg.TEST.BUCKET_QUANT = 0  # shape-bucketed testval eval; 0 = off
cfg.TEST.SPATIAL_SHARD = False  # shard image height across devices

# ---------------------------------------------------------------- visual
cfg.VISUAL = SegmentronConfig()
cfg.VISUAL.OUTPUT_DIR = "runs/visual/"

# ---------------------------------------------------------------- model
cfg.MODEL = SegmentronConfig()
cfg.MODEL.MODEL_NAME = ""
cfg.MODEL.BACKBONE = ""
cfg.MODEL.BACKBONE_SCALE = 1.0
cfg.MODEL.MULTI_LOSS_WEIGHT = [1.0]
cfg.MODEL.DEFAULT_GROUP_NUMBER = 32
cfg.MODEL.DEFAULT_EPSILON = 1e-5
cfg.MODEL.BN_TYPE = "BN"  # BN | SyncBN | FrozenBN | GN
cfg.MODEL.BN_EPS_FOR_ENCODER = None
cfg.MODEL.BN_EPS_FOR_DECODER = None
cfg.MODEL.OUTPUT_STRIDE = 16
cfg.MODEL.BN_MOMENTUM = None  # torch-convention momentum

cfg.MODEL.DANET = SegmentronConfig()
cfg.MODEL.DANET.MULTI_DILATION = None
cfg.MODEL.DANET.MULTI_GRID = False

cfg.MODEL.DEEPLABV3_PLUS = SegmentronConfig()
cfg.MODEL.DEEPLABV3_PLUS.USE_ASPP = True
cfg.MODEL.DEEPLABV3_PLUS.ENABLE_DECODER = True
cfg.MODEL.DEEPLABV3_PLUS.ASPP_WITH_SEP_CONV = True
cfg.MODEL.DEEPLABV3_PLUS.DECODER_USE_SEP_CONV = True

cfg.MODEL.OCNet = SegmentronConfig()
cfg.MODEL.OCNet.OC_ARCH = "base"  # base | pyramid | asp

cfg.MODEL.ENCNET = SegmentronConfig()
cfg.MODEL.ENCNET.SE_LOSS = True
cfg.MODEL.ENCNET.SE_WEIGHT = 0.2
cfg.MODEL.ENCNET.LATERAL = True

cfg.MODEL.CCNET = SegmentronConfig()
cfg.MODEL.CCNET.RECURRENCE = 2

cfg.MODEL.CGNET = SegmentronConfig()
cfg.MODEL.CGNET.STAGE2_BLOCK_NUM = 3
cfg.MODEL.CGNET.STAGE3_BLOCK_NUM = 21

cfg.MODEL.POINTREND = SegmentronConfig()
cfg.MODEL.POINTREND.BASEMODEL = "DeepLabV3_Plus"
cfg.MODEL.POINTREND.NUM_POINTS = 1024
cfg.MODEL.POINTREND.OVERSAMPLE = 3
cfg.MODEL.POINTREND.IMPORTANCE = 0.75
cfg.MODEL.POINTREND.SUBDIVISION_STEPS = 2
cfg.MODEL.POINTREND.SUBDIVISION_POINTS = 2048

cfg.MODEL.XCEPTION = SegmentronConfig()
cfg.MODEL.XCEPTION.MIDDLE_BLOCKS = 16  # 16 = Xception-65; fewer give
#   width-true slim variants for tests

cfg.MODEL.HRNET = SegmentronConfig()
cfg.MODEL.HRNET.PRETRAINED_LAYERS = ["*"]
cfg.MODEL.HRNET.STEM_INPLANES = 64
cfg.MODEL.HRNET.FINAL_CONV_KERNEL = 1
cfg.MODEL.HRNET.WITH_HEAD = True
cfg.MODEL.HRNET.OCR = SegmentronConfig()
cfg.MODEL.HRNET.OCR.ENABLE = False
cfg.MODEL.HRNET.OCR.MID_CHANNELS = 512
cfg.MODEL.HRNET.OCR.KEY_CHANNELS = 256

# ---------------------------------------------------------------- tpu
# The JAX package's accelerator block, kept key for key (module
# docstring says which keys this package reads).
cfg.TPU = SegmentronConfig()
cfg.TPU.MESH_SHAPE = []
cfg.TPU.MESH_AXES = ["data"]
cfg.TPU.COMPUTE_DTYPE = "float32"  # float32 | bfloat16
cfg.TPU.PREFETCH = 2
cfg.TPU.REMAT = "none"
cfg.TPU.DEVICE_AUGMENT = True
cfg.TPU.DEVICE_NORMALIZE = True  # testval: ship raw uint8 and normalize
#   on the device, (x/255 - mean)/std
cfg.TPU.USE_PALLAS = True
cfg.TPU.USE_PALLAS_SEPCONV = False
cfg.TPU.DONATE = True
cfg.TPU.INT8_ACTIVATIONS = False
cfg.TPU.INT8_K = 6.0
cfg.TPU.INT8_RESNET = False
cfg.TPU.INT8_CALIBRATE = False
cfg.TPU.INT8_CALIBRATION_BATCHES = 0
cfg.TPU.INT8_CALIBRATION_HEADROOM = 1.25
cfg.TPU.FUSED_SEPCONV_V3 = False
cfg.TPU.FUSED_ENTRY_V3 = ""
cfg.TPU.FUSED_SEPCONV_MIN_BYTES = 80 * 1024 * 1024
cfg.TPU.DW_SHIFT = True
cfg.TPU.DW_BWD_SHIFT = False
cfg.TPU.SCOPED_VMEM_KIB = 0
cfg.TPU.FUSED_STEM = "block1"  # Xception entry chain as one kernel:
#   False = off; "stem" = conv1+conv2; "block1" = stem + block1
#   (ops/entrychain.py). Eval only, gated in
#   models/backbones/xception.py::Xception65._fused_stem_mode.
cfg.TPU.ELIDE_COLLECTIVES = True
cfg.TPU.STEM_WBLOCK = True

# ---------------------------------------------------------------- utils
cfg.UTILS = SegmentronConfig()
cfg.UTILS.EPOCH_STOP = -1
cfg.UTILS.DEBUG_NANS = False
cfg.UTILS.PROFILE_STEPS = 0
cfg.UTILS.PROFILE_START = 10
cfg.UTILS.PROFILE_DIR = "runs/profile"
