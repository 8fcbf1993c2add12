"""StreamPETR: ``StreamPETRConfig`` and ``StreamPETR`` on either side; the
program's streaming entry is ``train.petr_step.make_petr_infer_step``."""

from harness.family import Base


class Family(Base):
    config_module, config_class = 'models.streampetr', 'StreamPETRConfig'
    model_module, model_class = 'models.streampetr', 'StreamPETR'

    @property
    def num_cams(self):
        return self.cfg.num_cams

    @property
    def input_hw(self):
        return tuple(self.cfg.input_hw)

    def image_norm(self):
        """(mean, std) the model normalizes uint8 images with."""
        c = self.mod('config')
        return c.IMG_MEAN, c.IMG_STD

    def init_state(self, device):
        return self.mod('models.streampetr').init_petr_state(1, self.cfg,
                                                            device)

    def infer_step(self):
        return self.mod('train.petr_step').make_petr_infer_step(self.cfg)

    def quantize(self, model, calib):
        return self.mod('ops.quant').quantize_petr_backbone(model, calib)

    def stages(self, model):
        """The modules whose inputs and outputs a checked frame keeps: the
        FPN, the StreamPETR head, its decoder and each decoder layer (by
        index)."""
        return {'neck': model.img_neck, 'head': model.pts_bbox_head,
                'decoder': self.decoder(model),
                **dict(enumerate(self.decoder_layers(model)))}

    def decoder(self, model):
        return model.pts_bbox_head.decoder

    def decoder_layers(self, model):
        """The decoder's layers, in order."""
        d = self.decoder(model)
        return [getattr(d, f'layer{i}') for i in range(d.num_layers)]

    def head2d_gaps(self, model, taken):
        """No 2D head at inference (the source's FocalHead is a training
        aid)."""
        return {}

    def head_on(self, model, taken, batch, state):
        """The head from the program's FPN level: the dense keys and their
        frustum position embedding, the memory, the queries."""
        return model.pts_bbox_head(
            taken['neck'][1], batch['lidar2img'], state,
            batch['prev_exists'], batch['timestamp'], batch['ego_pose'],
            batch['ego_pose_inv'])

    def spans(self, model, spans):
        """backbone: from the detector's forward to its neck's (with the
        int8 path's input quantization); head: the StreamPETR head."""
        spans.add('backbone', model, model.img_neck, end_pre=True)
        spans.add('head', model.pts_bbox_head, model.pts_bbox_head)
