"""The config factories that the ported configs are built on: a copy of
`faster_fpn_config`, `standard_transforms`, `retina_fpn_config`,
`trident_c4_config`, `multiscale_transforms`, `mask_fpn_config` and
`reppoints_config` from `simpledet_tpu/config_templates.py`, kept in the
port so that it imports nothing of the JAX package (`multiscale_transforms`
takes its RandResize2DImageBbox from the port's `data/transforms.py`;
`reppoints_config(multiscale=True)` trains on it). A neck, head or
backbone that a config passes to a template (FreeAnchor's head, SEPC,
NASFPN, EfficientNet to `retina_fpn_config`; the SE backbone and mask head
to `mask_fpn_config`; the DCN backbones to `trident_c4_config` and
`reppoints_config`) is recorded as the stand-in it is, and
`dsl.build_detector` builds it or refuses it by name.
`mask_fpn_config` sets its normalizer on every param class; the port
normalises the backbone only, as the JAX DSL does (`dsl.py`).

`core.config.read_config` serves this module for the import
`simpledet_tpu.config_templates` while a config runs. Like the config files,
it imports the repo-root shims (`mxnext.complicate`, `models.FPN.builder`,
`symbol.builder`, `core.detection_input`, `core.detection_metric`), which
`read_config` serves as stand-ins at that time. A template that is not copied
here raises NotImplementedError naming itself.
"""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(f"config template {name!r} of "
                              "simpledet_tpu.config_templates is not ported")


def faster_fpn_config(is_train, name, *, depth=50, variant="v1",
                      fp16=False, schedule_mult=1, backbone=None, neck=None,
                      rpn_head=None, bbox_head=None, detector=None,
                      num_class=81, neck_attrs=None, norm_type="fixbn"):
    from mxnext.complicate import normalizer_factory

    class General:
        log_frequency = 10
        batch_image = 2 if is_train else 1
        loader_worker = 8

    General.name = name.rsplit("/")[-1].rsplit(".")[-1]
    General.fp16 = fp16

    class KvstoreParam:
        kvstore = "mesh"
        batch_image = General.batch_image
        gpus = list(range(8))
        fp16 = General.fp16

    class NormalizeParam:
        normalizer = normalizer_factory(type=norm_type,
                                        ndev=len(KvstoreParam.gpus))

    class BackboneParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer

    BackboneParam.depth = depth

    class NeckParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer

    class RpnParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer
        batch_image = General.batch_image
        nnvm_proposal = True
        nnvm_rpn_target = True

        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)
            image_anchor = 256
            max_side = 1400

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 256
            pos_fraction = 0.5

        class head:
            conv_channel = 256
            mean = (0, 0, 0, 0)
            std = (1, 1, 1, 1)

        class proposal:
            pre_nms_top_n = 2000 if is_train else 1000
            post_nms_top_n = 2000 if is_train else 1000
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            image_roi = 512
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            num_reg_class = num_class
            class_agnostic = False
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    class BboxParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer
        image_roi = 512
        batch_image = General.batch_image

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    BboxParam.num_class = num_class

    class RoiParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer
        out_size = 7
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    class DatasetParam:
        if is_train:
            image_set = ("coco_train2017",)
        else:
            image_set = ("coco_val2017",)

    # components -------------------------------------------------------------
    if backbone is None:
        from models.FPN import builder as fpn_builder
        bb_name = {
            ("v1", 50): "MSRAResNet50V1FPN", ("v1", 101): "MSRAResNet101V1FPN",
            ("v1b", 50): "ResNet50V1bFPN", ("v1b", 101): "ResNet101V1bFPN",
            ("v1b", 152): "ResNet152V1bFPN",
            ("v1d", 50): "ResNet50V1dFPN",
        }[(variant, depth)]
        backbone = getattr(fpn_builder, bb_name)
    from models.FPN.builder import (FPNBbox2fcHead, FPNNeck, FPNRoiAlign,
                                    FPNRpnHead)
    from symbol.builder import FasterRcnn
    neck = neck or FPNNeck
    rpn_head = rpn_head or FPNRpnHead
    bbox_head = bbox_head or FPNBbox2fcHead
    detector = (detector or FasterRcnn)()

    bb = backbone(BackboneParam)
    for k, v in (neck_attrs or {}).items():
        setattr(NeckParam, k, v)
    nk = neck(NeckParam)
    rh = rpn_head(RpnParam)
    re = FPNRoiAlign(RoiParam)
    bh = bbox_head(BboxParam)
    if is_train:
        train_sym = detector.get_train_symbol(bb, nk, rh, re, bh)
        test_sym = None
        rpn_test_sym = None
    else:
        train_sym = None
        test_sym = detector.get_test_symbol(bb, nk, rh, re, bh)
        rpn_test_sym = detector.get_rpn_test_symbol(bb, nk, rh)

    class ModelParam:
        train_symbol = train_sym
        test_symbol = test_sym
        rpn_test_symbol = rpn_test_sym
        from_scratch = False
        random = True
        memonger = False
        memonger_until = "stage3"

        class pretrain:
            epoch = 0
            fixed_param = ["conv0", "stage1", "scale", "bias"]

    ModelParam.pretrain.prefix = f"pretrain_model/resnet-{variant}-{depth}"

    n_dev_img = len(KvstoreParam.gpus) * KvstoreParam.batch_image

    class OptimizeParam:
        class optimizer:
            type = "sgd"
            lr = 0.01 / 8 * n_dev_img
            momentum = 0.9
            wd = 0.0001
            clip_gradient = None

        class schedule:
            begin_epoch = 0
            end_epoch = 6 * schedule_mult
            lr_iter = [60000 * 16 * schedule_mult // n_dev_img,
                       80000 * 16 * schedule_mult // n_dev_img]
            iter_per_epoch = 90000 * 16 // n_dev_img // 6

        class warmup:
            type = "gradual"
            lr = 0.01 / 8 * n_dev_img / 3.0
            iter = 500

    class TestParam:
        min_det_score = 0.05
        max_det_per_image = 100
        process_roidb = lambda x: x          # noqa: E731
        process_output = lambda x, y: x      # noqa: E731

        class model:
            epoch = 6 * schedule_mult

        class nms:
            type = "nms"
            thr = 0.5

        class coco:
            annotation = "data/coco/annotations/instances_val2017.json"

    TestParam.model.prefix = f"experiments/{General.name}/checkpoint"

    transform, data_name, label_name = standard_transforms(is_train)
    import core.detection_metric as metric
    metric_list = [
        metric.AccWithIgnore("RpnAcc", ["rpn_cls_logit", "rpn_label"], []),
        metric.AccWithIgnore("RcnnAcc", ["bbox_cls_logit", "bbox_label"], []),
    ]
    return (General, KvstoreParam, RpnParam, RoiParam, BboxParam,
            DatasetParam, ModelParam, OptimizeParam, TestParam,
            transform, data_name, label_name, metric_list)


def standard_transforms(is_train, short=800, long=1333, max_num_gt=100):
    class NormParam:
        mean = (122.7717, 115.9465, 102.9801)
        std = (1.0, 1.0, 1.0)

    class ResizeParam:
        pass

    ResizeParam.short = short
    ResizeParam.long = long

    class PadParam:
        pass

    PadParam.short = short
    PadParam.long = long
    PadParam.max_num_gt = max_num_gt

    class RenameParam:
        mapping = dict(image="data")

    from core.detection_input import (ConvertImageFromHwcToChw,
                                      Flip2DImageBbox, Norm2DImage,
                                      Pad2DImageBbox, ReadRoiRecord,
                                      RenameRecord, Resize2DImageBbox)
    if is_train:
        transform = [
            ReadRoiRecord(None), Norm2DImage(NormParam),
            Resize2DImageBbox(ResizeParam), Flip2DImageBbox(),
            Pad2DImageBbox(PadParam), ConvertImageFromHwcToChw(),
            RenameRecord(RenameParam.mapping),
        ]
        return transform, ["data"], ["gt_bbox", "im_info"]
    transform = [
        ReadRoiRecord(None), Norm2DImage(NormParam),
        Resize2DImageBbox(ResizeParam), Pad2DImageBbox(PadParam),
        ConvertImageFromHwcToChw(), RenameRecord(RenameParam.mapping),
    ]
    return transform, ["data", "im_info", "im_id", "rec_id"], []


def retina_fpn_config(is_train, name, *, depth=50, variant="v1", fp16=False,
                      neck=None, head=None, neck_args=None, num_class=81,
                      scale_octaves=True, schedule_mult=1):
    """RetinaNet-style single-stage grid (also FreeAnchor/SEPC via
    neck/head overrides)."""
    from mxnext.complicate import normalizer_factory

    class General:
        log_frequency = 10
        batch_image = 2 if is_train else 1
        loader_worker = 8

    General.name = name.rsplit("/")[-1].rsplit(".")[-1]
    General.fp16 = fp16

    class KvstoreParam:
        kvstore = "mesh"
        batch_image = General.batch_image
        gpus = list(range(8))
        fp16 = General.fp16

    class NormalizeParam:
        normalizer = normalizer_factory(type="fixbn")

    class BackboneParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer

    BackboneParam.depth = depth

    class NeckParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer

    class RpnParam:
        fp16 = General.fp16
        normalizer = NormalizeParam.normalizer
        batch_image = General.batch_image
        sync_loss = True

        class anchor_generate:
            scale = (4 * 2 ** 0, 4 * 2 ** (1.0 / 3.0), 4 * 2 ** (2.0 / 3.0))
            ratio = (0.5, 1.0, 2.0)
            stride = (8, 16, 32, 64, 128)
            image_anchor = None

        class anchor_assign:
            allowed_border = 9999
            pos_thr = 0.5
            neg_thr = 0.4
            min_pos_thr = 0.0

        class head:
            conv_channel = 256
            mean = None
            std = None

        class proposal:
            pre_nms_top_n = 1000
            post_nms_top_n = None
            nms_thr = None
            min_bbox_side = None
            min_det_score = 0.05

        class focal_loss:
            alpha = 0.25
            gamma = 2.0

    RpnParam.num_class = num_class

    class BboxParam:
        pass

    class RoiParam:
        pass

    class DatasetParam:
        if is_train:
            image_set = ("coco_train2017",)
        else:
            image_set = ("coco_val2017",)

    from models.retinanet import builder as retina_builder
    from models.FPN import builder as fpn_builder
    bb_name = {
        ("v1", 50): "MSRAResNet50V1FPN", ("v1", 101): "MSRAResNet101V1FPN",
        ("v1b", 50): "ResNet50V1bFPN", ("v1b", 101): "ResNet101V1bFPN",
        ("v1b", 152): "ResNet152V1bFPN",
    }[(variant, depth)]
    backbone_cls = getattr(retina_builder, bb_name, None) or \
        getattr(fpn_builder, bb_name)
    neck = neck or retina_builder.RetinaNetNeck
    head = head or retina_builder.RetinaNetHead
    detector = retina_builder.RetinaNet()

    bb = backbone_cls(BackboneParam)
    nk = neck(NeckParam) if neck_args is None else neck(NeckParam, neck_args)
    hd = head(RpnParam)
    if is_train:
        train_sym = detector.get_train_symbol(bb, nk, hd)
        test_sym = None
    else:
        train_sym = None
        test_sym = detector.get_test_symbol(bb, nk, hd)

    class ModelParam:
        train_symbol = train_sym
        test_symbol = test_sym
        rpn_test_symbol = None
        from_scratch = False
        random = True
        memonger = False

        class pretrain:
            epoch = 0
            fixed_param = ["conv0", "stage1", "scale", "bias"]

    ModelParam.pretrain.prefix = f"pretrain_model/resnet-{variant}-{depth}"

    n_dev_img = len(KvstoreParam.gpus) * KvstoreParam.batch_image

    class OptimizeParam:
        class optimizer:
            type = "sgd"
            lr = 0.005 / 8 * n_dev_img
            momentum = 0.9
            wd = 0.0001
            clip_gradient = None

        class schedule:
            begin_epoch = 0
            end_epoch = 6 * schedule_mult
            lr_iter = [60000 * 16 * schedule_mult // n_dev_img,
                       80000 * 16 * schedule_mult // n_dev_img]
            iter_per_epoch = 90000 * 16 // n_dev_img // 6

        class warmup:
            type = "gradual"
            lr = 0.005 / 8 * n_dev_img / 3.0
            iter = 500

    class TestParam:
        min_det_score = 0
        max_det_per_image = 100
        process_roidb = lambda x: x          # noqa: E731
        process_output = lambda x, y: x      # noqa: E731

        class model:
            epoch = 6 * schedule_mult

        class nms:
            type = "nms"
            thr = 0.5

        class coco:
            annotation = "data/coco/annotations/instances_val2017.json"

    TestParam.model.prefix = f"experiments/{General.name}/checkpoint"

    transform, data_name, label_name = standard_transforms(is_train)
    import core.detection_metric as metric
    metric_list = [metric.ScalarLoss("ClsLoss", ["retina_cls_loss"], [])]
    return (General, KvstoreParam, RpnParam, RoiParam, BboxParam,
            DatasetParam, ModelParam, OptimizeParam, TestParam,
            transform, data_name, label_name, metric_list)


def trident_c4_config(is_train, name, *, depth=50, resnet_variant="v2",
                      num_branch=3, fast=False, scaleaware=True,
                      image_roi=128, batch_image=1, schedule_mult=1,
                      multiscale=False, addminival=False, fp16=False,
                      syncbn=False, from_scratch=False, num_class=81,
                      backbone=None, bbox_head=None):
    """TridentNet / plain-C4 Faster R-CNN config family (reference
    config/tridentnet_*.py, config/resnet_v1b/tridentnet_*.py,
    config/faster_r50v2c4_c5_256roi_1x.py).

    fast=True is the TridentNet-Fast approximation (reference
    tridentnet_fast_* / *_fastapprox_*): train all branches without
    scale-aware filtering, test only the middle (dilation-2) branch.
    num_branch=1 (with scaleaware=False) degenerates to single-branch C4.
    """
    from mxnext.complicate import normalizer_factory

    class Trident:
        pass

    Trident.num_branch = num_branch
    Trident.branch_dilates = list(range(1, num_branch + 1))
    if fast:
        Trident.train_scaleaware = False
        Trident.test_scaleaware = False
        Trident.valid_ranges = None
        if not is_train:
            Trident.num_branch = 1
            Trident.branch_dilates = [2] if num_branch >= 2 else [1]
    else:
        Trident.train_scaleaware = scaleaware and num_branch > 1
        Trident.test_scaleaware = scaleaware and num_branch > 1
        Trident.valid_ranges = \
            [(0, 90), (30, 160), (90, -1)] if num_branch == 3 else None

    class General:
        log_frequency = 10
        loader_worker = 8

    General.name = name.rsplit("/")[-1].rsplit(".")[-1]
    General.fp16 = fp16
    General.batch_image = batch_image if is_train else 1

    class KvstoreParam:
        kvstore = "mesh"
        gpus = list(range(8))

    KvstoreParam.batch_image = General.batch_image
    KvstoreParam.fp16 = General.fp16

    class NormalizeParam:
        normalizer = normalizer_factory(type="syncbn", ndev=8) if syncbn \
            else normalizer_factory(type="fixbn")

    class BackboneParam:
        trident = Trident

    BackboneParam.fp16 = General.fp16
    BackboneParam.normalizer = NormalizeParam.normalizer
    BackboneParam.depth = depth

    class NeckParam:
        pass

    NeckParam.fp16 = General.fp16
    NeckParam.normalizer = NormalizeParam.normalizer

    class RpnParam:
        class anchor_generate:
            scale = (2, 4, 8, 16, 32)
            ratio = (0.5, 1.0, 2.0)
            stride = (16,)
            image_anchor = 256

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 256
            pos_fraction = 0.5

        class head:
            conv_channel = 512
            mean = (0, 0, 0, 0)
            std = (1, 1, 1, 1)

        class proposal:
            pre_nms_top_n = 12000 if is_train else 6000
            post_nms_top_n = 500 if is_train else 300
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            num_reg_class = 2
            class_agnostic = True
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    RpnParam.fp16 = General.fp16
    RpnParam.normalizer = NormalizeParam.normalizer
    RpnParam.batch_image = General.batch_image * Trident.num_branch
    RpnParam.subsample_proposal.image_roi = image_roi

    class BboxParam:
        class regress_target:
            class_agnostic = True
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    BboxParam.fp16 = General.fp16
    BboxParam.normalizer = NormalizeParam.normalizer
    BboxParam.num_class = num_class
    BboxParam.depth = depth
    BboxParam.variant = resnet_variant
    BboxParam.image_roi = image_roi
    BboxParam.batch_image = General.batch_image * Trident.num_branch

    class RoiParam:
        out_size = 14
        stride = 16

    RoiParam.fp16 = General.fp16
    RoiParam.normalizer = NormalizeParam.normalizer

    class DatasetParam:
        if is_train:
            image_set = ("coco_train2017", "coco_val2017") if addminival \
                else ("coco_train2017",)
        else:
            image_set = ("coco_val2017",)

    from models.tridentnet.builder import (BboxC5Head, TridentFasterRcnn,
                                           TridentRpnHead)
    from models.tridentnet.builder_v2 import (TridentResNetV1C4,
                                              TridentResNetV1bC4,
                                              TridentResNetV2C4)
    from symbol.builder import BboxC5V1Head, Neck
    from symbol.builder import RoiAlign as RoiExtractor

    backbone_cls = backbone or \
        {"v1": TridentResNetV1C4, "v1b": TridentResNetV1bC4,
         "v2": TridentResNetV2C4}[resnet_variant]
    bbox_head_cls = bbox_head or \
        (BboxC5Head if resnet_variant == "v2" else BboxC5V1Head)

    backbone = backbone_cls(BackboneParam)
    neck = Neck(NeckParam)
    rpn_head = TridentRpnHead(RpnParam)
    roi_extractor = RoiExtractor(RoiParam)
    bbox_head = bbox_head_cls(BboxParam)
    detector = TridentFasterRcnn()
    if is_train:
        train_sym = detector.get_train_symbol(
            backbone, neck, rpn_head, roi_extractor, bbox_head,
            num_branch=Trident.num_branch,
            scaleaware=Trident.train_scaleaware,
            valid_ranges=Trident.valid_ranges)
        test_sym = None
    else:
        train_sym = None
        test_sym = detector.get_test_symbol(
            backbone, neck, rpn_head, roi_extractor, bbox_head,
            num_branch=Trident.num_branch,
            scaleaware=Trident.test_scaleaware,
            valid_ranges=Trident.valid_ranges)

    class ModelParam:
        train_symbol = train_sym
        test_symbol = test_sym
        rpn_test_symbol = None
        random = True
        memonger = False

        class pretrain:
            epoch = 0

    ModelParam.from_scratch = from_scratch
    ModelParam.pretrain.prefix = \
        f"pretrain_model/resnet-{resnet_variant}-{depth}"
    ModelParam.pretrain.fixed_param = \
        [] if from_scratch else ["conv0", "stage1", "scale", "bias"]

    n_dev_img = len(KvstoreParam.gpus) * KvstoreParam.batch_image

    class OptimizeParam:
        class optimizer:
            type = "sgd"
            momentum = 0.9
            wd = 0.0001
            clip_gradient = None

        class schedule:
            begin_epoch = 0

        class warmup:
            type = "gradual"
            iter = 500

    OptimizeParam.optimizer.lr = 0.01 / 8 * n_dev_img
    OptimizeParam.warmup.lr = 0.01 / 8 * n_dev_img / 3.0
    OptimizeParam.schedule.end_epoch = 6 * schedule_mult
    OptimizeParam.schedule.lr_iter = [
        60000 * 16 * schedule_mult // n_dev_img,
        80000 * 16 * schedule_mult // n_dev_img]
    OptimizeParam.schedule.iter_per_epoch = 90000 * 16 // n_dev_img // 6

    class TestParam:
        min_det_score = 0.05
        max_det_per_image = 100
        process_roidb = lambda x: x          # noqa: E731
        process_output = lambda x, y: x      # noqa: E731

        class model:
            pass

        class nms:
            type = "nms"
            thr = 0.5

        class coco:
            annotation = "data/coco/annotations/instances_val2017.json"

    TestParam.model.prefix = f"experiments/{General.name}/checkpoint"
    TestParam.model.epoch = 6 * schedule_mult

    if multiscale and is_train:
        transform, data_name, label_name = multiscale_transforms(is_train)
    else:
        transform, data_name, label_name = standard_transforms(is_train)

    import core.detection_metric as metric
    metric_list = [
        metric.AccWithIgnore("RpnAcc", ["rpn_cls_logit", "rpn_label"], []),
        metric.AccWithIgnore("RcnnAcc", ["bbox_cls_logit", "bbox_label"], []),
    ]
    return (General, KvstoreParam, RpnParam, RoiParam, BboxParam,
            DatasetParam, ModelParam, OptimizeParam, TestParam,
            transform, data_name, label_name, metric_list)


def multiscale_transforms(is_train, scales=((600, 1000), (800, 1333),
                                            (1000, 1600)), max_num_gt=100):
    """Multi-scale train pipeline (reference RandResize2DImageBbox,
    core/detection_input.py:158-181): random short/long per record, padded
    to the largest scale."""
    class NormParam:
        mean = (122.7717, 115.9465, 102.9801)
        std = (1.0, 1.0, 1.0)

    class RandResizeParam:
        pass

    RandResizeParam.short = [s for s, _ in scales]
    RandResizeParam.long = [l for _, l in scales]

    class PadParam:
        pass

    PadParam.short = max(s for s, _ in scales)
    PadParam.long = max(l for _, l in scales)
    PadParam.max_num_gt = max_num_gt

    class RenameParam:
        mapping = dict(image="data")

    from core.detection_input import (ConvertImageFromHwcToChw,
                                      Flip2DImageBbox, Norm2DImage,
                                      Pad2DImageBbox, ReadRoiRecord,
                                      RenameRecord)
    from simpledet_torch.data.transforms import RandResize2DImageBbox
    transform = [
        ReadRoiRecord(None), Norm2DImage(NormParam),
        RandResize2DImageBbox(RandResizeParam), Flip2DImageBbox(),
        Pad2DImageBbox(PadParam), ConvertImageFromHwcToChw(),
        RenameRecord(RenameParam.mapping),
    ]
    return transform, ["data"], ["gt_bbox", "im_info"]


def mask_fpn_config(is_train, name, *, depth=50, variant="v1",
                    schedule_mult=1, fp16=False, norm_type="fixbn",
                    from_scratch=False, mask_head=None, backbone=None,
                    num_class=81):
    """Mask R-CNN FPN config family (reference config/mask_r50v1_fpn_1x.py,
    config/resnet_v1b/mask_*.py, config/scratch/mask_*_scratch_2x.py,
    config/se/mask_se-r50v1b_fpn_bn_scratch_2x.py)."""
    from mxnext.complicate import normalizer_factory

    class General:
        log_frequency = 10
        loader_worker = 8

    General.name = name.rsplit("/")[-1].rsplit(".")[-1]
    General.fp16 = fp16
    General.batch_image = 2 if is_train else 1

    class KvstoreParam:
        kvstore = "mesh"
        gpus = list(range(8))

    KvstoreParam.batch_image = General.batch_image
    KvstoreParam.fp16 = General.fp16

    class NormalizeParam:
        pass

    NormalizeParam.normalizer = normalizer_factory(
        type=norm_type, ndev=len(KvstoreParam.gpus))

    class BackboneParam:
        pass

    BackboneParam.fp16 = General.fp16
    BackboneParam.normalizer = NormalizeParam.normalizer
    BackboneParam.depth = depth

    class NeckParam:
        pass

    NeckParam.fp16 = General.fp16
    NeckParam.normalizer = NormalizeParam.normalizer

    class RpnParam:
        nnvm_proposal = True
        nnvm_rpn_target = True

        class anchor_generate:
            scale = (8,)
            ratio = (0.5, 1.0, 2.0)
            stride = (4, 8, 16, 32, 64)
            image_anchor = 256
            max_side = 1400

        class anchor_assign:
            allowed_border = 0
            pos_thr = 0.7
            neg_thr = 0.3
            min_pos_thr = 0.0
            image_anchor = 256
            pos_fraction = 0.5

        class head:
            conv_channel = 256
            mean = (0, 0, 0, 0)
            std = (1, 1, 1, 1)

        class proposal:
            pre_nms_top_n = 2000 if is_train else 1000
            post_nms_top_n = 2000 if is_train else 1000
            nms_thr = 0.7
            min_bbox_side = 0

        class subsample_proposal:
            proposal_wo_gt = False
            image_roi = 512
            fg_fraction = 0.25
            fg_thr = 0.5
            bg_thr_hi = 0.5
            bg_thr_lo = 0.0

        class bbox_target:
            class_agnostic = False
            weight = (1.0, 1.0, 1.0, 1.0)
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    RpnParam.fp16 = General.fp16
    RpnParam.normalizer = NormalizeParam.normalizer
    RpnParam.batch_image = General.batch_image
    RpnParam.bbox_target.num_reg_class = num_class

    class BboxParam:
        image_roi = 512

        class regress_target:
            class_agnostic = False
            mean = (0.0, 0.0, 0.0, 0.0)
            std = (0.1, 0.1, 0.2, 0.2)

    BboxParam.fp16 = General.fp16
    BboxParam.normalizer = NormalizeParam.normalizer
    BboxParam.num_class = num_class
    BboxParam.batch_image = General.batch_image

    class MaskParam:
        resolution = 28
        dim_reduced = 256

    MaskParam.fp16 = General.fp16
    MaskParam.normalizer = NormalizeParam.normalizer
    MaskParam.num_fg_roi = int(RpnParam.subsample_proposal.image_roi *
                               RpnParam.subsample_proposal.fg_fraction)

    class RoiParam:
        out_size = 7
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    RoiParam.fp16 = General.fp16
    RoiParam.normalizer = NormalizeParam.normalizer

    class MaskRoiParam:
        out_size = 14
        stride = (4, 8, 16, 32)
        roi_canonical_scale = 224
        roi_canonical_level = 4

    MaskRoiParam.fp16 = General.fp16
    MaskRoiParam.normalizer = NormalizeParam.normalizer

    class DatasetParam:
        if is_train:
            image_set = ("coco_train2017",)
        else:
            image_set = ("coco_val2017",)

    class TestParam:
        min_det_score = 0.05
        max_det_per_image = 100
        process_roidb = lambda x: x          # noqa: E731
        process_output = lambda x, y: x      # noqa: E731

        class model:
            pass

        class nms:
            type = "nms"
            thr = 0.5

        class coco:
            annotation = "data/coco/annotations/instances_val2017.json"

    TestParam.model.prefix = f"experiments/{General.name}/checkpoint"
    TestParam.model.epoch = 6 * schedule_mult

    from models.maskrcnn.builder import (BboxPostProcessor, FPNBbox2fcHead,
                                         FPNNeck, FPNRoiAlign,
                                         MaskFasterRcnn,
                                         MaskFasterRcnn4ConvHead,
                                         MaskFPNRpnHead)
    if backbone is None:
        from models.FPN import builder as fpn_builder
        bb_name = {
            ("v1", 50): "MSRAResNet50V1FPN",
            ("v1", 101): "MSRAResNet101V1FPN",
            ("v1b", 50): "ResNet50V1bFPN", ("v1b", 101): "ResNet101V1bFPN",
            ("v1b", 152): "ResNet152V1bFPN",
        }[(variant, depth)]
        backbone = getattr(fpn_builder, bb_name)
    mask_head_cls = mask_head or MaskFasterRcnn4ConvHead

    bb = backbone(BackboneParam)
    nk = FPNNeck(NeckParam)
    rh = MaskFPNRpnHead(RpnParam, MaskParam)
    re = FPNRoiAlign(RoiParam)
    mre = FPNRoiAlign(MaskRoiParam)
    bh = FPNBbox2fcHead(BboxParam)
    mh = mask_head_cls(BboxParam, MaskParam, MaskRoiParam)
    bpp = BboxPostProcessor(TestParam)
    detector = MaskFasterRcnn()
    if is_train:
        train_sym = detector.get_train_symbol(bb, nk, rh, re, mre, bh, mh)
        test_sym = None
    else:
        train_sym = None
        test_sym = detector.get_test_symbol(bb, nk, rh, re, mre, bh, mh, bpp)

    class ModelParam:
        train_symbol = train_sym
        test_symbol = test_sym
        rpn_test_symbol = None
        random = True
        memonger = False
        memonger_until = "stage3"

        class pretrain:
            epoch = 0

    ModelParam.from_scratch = from_scratch
    ModelParam.pretrain.prefix = f"pretrain_model/resnet-{variant}-{depth}"
    ModelParam.pretrain.fixed_param = \
        [] if from_scratch else ["conv0", "stage1", "scale", "bias"]

    n_dev_img = len(KvstoreParam.gpus) * KvstoreParam.batch_image

    class OptimizeParam:
        class optimizer:
            type = "sgd"
            momentum = 0.9
            wd = 0.0001
            clip_gradient = None

        class schedule:
            begin_epoch = 0

        class warmup:
            type = "gradual"
            iter = 500

    OptimizeParam.optimizer.lr = 0.01 / 8 * n_dev_img
    OptimizeParam.warmup.lr = 0.01 / 8 * n_dev_img / 3.0
    OptimizeParam.schedule.end_epoch = 6 * schedule_mult
    OptimizeParam.schedule.lr_iter = [
        60000 * 16 * schedule_mult // n_dev_img,
        80000 * 16 * schedule_mult // n_dev_img]
    OptimizeParam.schedule.iter_per_epoch = 90000 * 16 // n_dev_img // 6

    class NormParam:
        mean = (122.7717, 115.9465, 102.9801)
        std = (1.0, 1.0, 1.0)

    class ResizeParam:
        short = 800
        long = 1333

    class PadParam:
        short = 800
        long = 1333
        max_num_gt = 100
        max_len_gt_poly = 2500

    class RenameParam:
        mapping = dict(image="data")

    from core.detection_input import ReadRoiRecord, RenameRecord
    from models.maskrcnn.input import (EncodeGtPoly, Flip2DImageBboxMask,
                                       Norm2DImage, Pad2DImageBboxMask,
                                       PreprocessGtPoly,
                                       Resize2DImageBboxMask)
    # the JAX package's copy imports these from simpledet_tpu.data.transforms,
    # which read_config serves by this module
    from simpledet_torch.data.transforms import (Pad2DImageBbox,
                                                 Resize2DImageBbox)
    if is_train:
        transform = [
            ReadRoiRecord(None),
            Norm2DImage(NormParam),
            PreprocessGtPoly(),
            Resize2DImageBboxMask(ResizeParam),
            Flip2DImageBboxMask(),
            Pad2DImageBboxMask(PadParam),
            EncodeGtPoly(PadParam),
            RenameRecord(RenameParam.mapping),
        ]
        data_name = ["data"]
        label_name = ["gt_bbox", "gt_poly", "im_info"]
    else:
        transform = [
            ReadRoiRecord(None),
            Norm2DImage(NormParam),
            Resize2DImageBbox(ResizeParam),
            Pad2DImageBbox(PadParam),
            RenameRecord(RenameParam.mapping),
        ]
        data_name = ["data", "im_info", "im_id", "rec_id"]
        label_name = []

    import core.detection_metric as metric
    metric_list = [
        metric.AccWithIgnore("RpnAcc", ["rpn_cls_logit", "rpn_label"], []),
        metric.AccWithIgnore("RcnnAcc", ["bbox_cls_logit", "bbox_label"], []),
        metric.ScalarLoss("MaskLoss", ["mask_loss"], []),
    ]
    return (General, KvstoreParam, RpnParam, RoiParam, BboxParam,
            DatasetParam, ModelParam, OptimizeParam, TestParam,
            transform, data_name, label_name, metric_list)


def reppoints_config(is_train, name, *, depth=50, variant="v1",
                     point_transform="moment", schedule_mult=1,
                     backbone=None, multiscale=False):
    """RepPoints config family (reference config/RepPoints/): moment/minmax
    transforms, r50/r101, optional DCN backbone + multiscale 2x."""
    from models.RepPoints.builder import (RepPointsDetector, RepPointsHead,
                                          FCOSFPNNeck)
    from models.FPN import builder as fpn_builder
    from mxnext.complicate import normalizer_factory

    class General:
        log_frequency = 10
        loader_worker = 8

    General.name = name.rsplit("/")[-1].rsplit(".")[-1]
    General.batch_image = 2 if is_train else 1
    General.fp16 = False

    class KvstoreParam:
        kvstore = "mesh"
        gpus = list(range(8))

    KvstoreParam.batch_image = General.batch_image
    KvstoreParam.fp16 = General.fp16

    class NormalizeParam:
        normalizer = normalizer_factory(type="fixbn")

    class BackboneParam:
        pass

    BackboneParam.fp16 = General.fp16
    BackboneParam.normalizer = NormalizeParam.normalizer
    BackboneParam.depth = depth

    class NeckParam:
        pass

    NeckParam.fp16 = General.fp16
    NeckParam.normalizer = NormalizeParam.normalizer

    class RpnParam:
        num_class = 1 + 80

        class point_generate:
            num_points = 9
            scale = 4
            stride = (8, 16, 32, 64, 128)

        class head:
            conv_channel = 256
            point_conv_channel = 256

        class proposal:
            pre_nms_top_n = 1000
            min_det_score = 0.05

        class point_target:
            target_scale = 4
            num_pos = 1

        class bbox_target:
            pos_iou_thr = 0.5
            neg_iou_thr = 0.4
            min_pos_iou = 0.0

        class focal_loss:
            alpha = 0.25
            gamma = 2.0

    RpnParam.fp16 = General.fp16
    RpnParam.normalizer = NormalizeParam.normalizer
    RpnParam.batch_image = General.batch_image
    RpnParam.point_generate.transform = point_transform

    class BboxParam:
        pass

    class RoiParam:
        pass

    class DatasetParam:
        if is_train:
            image_set = ("coco_train2017",)
        else:
            image_set = ("coco_val2017",)

    if backbone is None:
        bb_name = {("v1", 50): "MSRAResNet50V1FPN",
                   ("v1", 101): "MSRAResNet101V1FPN",
                   ("v1b", 50): "ResNet50V1bFPN",
                   ("v1b", 101): "ResNet101V1bFPN"}[(variant, depth)]
        backbone = getattr(fpn_builder, bb_name)
    bb = backbone(BackboneParam)
    neck = FCOSFPNNeck(NeckParam)
    head = RepPointsHead(RpnParam)
    detector = RepPointsDetector()
    if is_train:
        train_sym = detector.get_train_symbol(bb, neck, head)
        test_sym = None
    else:
        train_sym = None
        test_sym = detector.get_test_symbol(bb, neck, head)

    class ModelParam:
        train_symbol = train_sym
        test_symbol = test_sym
        rpn_test_symbol = None
        from_scratch = False
        random = True
        memonger = False

        class pretrain:
            epoch = 0
            fixed_param = ["conv0", "stage1", "scale", "bias"]

    ModelParam.pretrain.prefix = f"pretrain_model/resnet-{variant}-{depth}"

    n_dev_img = len(KvstoreParam.gpus) * KvstoreParam.batch_image

    class OptimizeParam:
        class optimizer:
            type = "sgd"
            momentum = 0.9
            wd = 0.0001
            clip_gradient = None

        class schedule:
            begin_epoch = 0

        class warmup:
            type = "gradual"
            iter = 500

    OptimizeParam.optimizer.lr = 0.01 / 8 * n_dev_img
    OptimizeParam.warmup.lr = 0.01 / 8 * n_dev_img / 3.0
    OptimizeParam.schedule.end_epoch = 6 * schedule_mult
    OptimizeParam.schedule.lr_iter = [
        60000 * 16 * schedule_mult // n_dev_img,
        80000 * 16 * schedule_mult // n_dev_img]
    OptimizeParam.schedule.iter_per_epoch = 90000 * 16 // n_dev_img // 6

    class TestParam:
        min_det_score = 0
        max_det_per_image = 100
        process_roidb = lambda x: x          # noqa: E731
        process_output = lambda x, y: x      # noqa: E731

        class model:
            pass

        class nms:
            type = "nms"
            thr = 0.5

        class coco:
            annotation = "data/coco/annotations/instances_val2017.json"

    TestParam.model.prefix = f"experiments/{General.name}/checkpoint"
    TestParam.model.epoch = 6 * schedule_mult

    if multiscale and is_train:
        transform, data_name, label_name = multiscale_transforms(is_train)
    else:
        transform, data_name, label_name = standard_transforms(is_train)
    import core.detection_metric as metric
    metric_list = [
        metric.ScalarLoss("ClsL", ["reppoints_cls_loss"], []),
        metric.ScalarLoss("InitL", ["reppoints_init_loss"], []),
        metric.ScalarLoss("RefineL", ["reppoints_refine_loss"], []),
    ]
    return (General, KvstoreParam, RpnParam, RoiParam, BboxParam,
            DatasetParam, ModelParam, OptimizeParam, TestParam,
            transform, data_name, label_name, metric_list)
