"""Far3D: ``Far3DConfig`` and ``Far3D`` on either side; the program's
streaming entry is ``train.step.make_infer_step``, its training step
``train.step.step_from_noise``."""

from harness.family import Base


class Family(Base):
    config_module, config_class = 'config', 'Far3DConfig'
    model_module, model_class = 'models.detector', 'Far3D'
    batch_keys = Base.batch_keys + ('intrinsics', 'extrinsics')
    rig_keys = ('lidar2img', 'intrinsics', 'extrinsics')

    @property
    def num_cams(self):
        return self.cfg.data.num_cams

    @property
    def input_hw(self):
        return tuple(self.cfg.data.input_hw)

    def image_norm(self):
        """(mean, std) the model normalizes uint8 images with."""
        return self.cfg.data.img_mean, self.cfg.data.img_std

    def init_state(self, device):
        return self.mod('models.farhead').init_state(1, self.cfg.head, device)

    def infer_step(self):
        return self.mod('train.step').make_infer_step(self.cfg)

    def quantize(self, model, calib):
        return self.mod('ops.quant').quantize_detector_backbone(model, calib)

    def stages(self, model):
        """The modules whose inputs and outputs a checked frame keeps: the
        FPN, the 2D head, FarHead, its decoder and each decoder layer (by
        index)."""
        head = model.pts_bbox_head
        return {'neck': model.img_neck, 'roi': model.img_roi_head,
                'head': head, 'decoder': self.decoder(model),
                **dict(enumerate(self.decoder_layers(model)))}

    def decoder(self, model):
        return model.pts_bbox_head.transformer['decoder']

    def decoder_layers(self, model):
        """The decoder's layers, in order."""
        return list(self.decoder(model).layers)

    def head2d_gaps(self, model, taken):
        """The YOLOX 2D head and depth net on the program's FPN output, in
        float32, against the program's maps (the worst)."""
        from harness.compare import worst_rel
        feats = [f.float() for f in taken['neck'][1]]
        return {'head2d_rel': worst_rel(taken['roi'][1],
                                        model.img_roi_head(feats))}

    def head_on(self, model, taken, batch, state):
        """The frame after the 2D head, from the program's FPN and 2D head
        outputs: the proposals' top-K, their lifting, FarHead."""
        return model.forward_head(
            taken['neck'][1], taken['roi'][1], 1, self.num_cams,
            batch['lidar2img'], batch['intrinsics'], batch['extrinsics'],
            state, batch['prev_exists'], batch['timestamp'],
            batch['ego_pose'], batch['ego_pose_inv'])

    def spans(self, model, spans):
        """backbone: from the detector's forward to its neck's (with the
        int8 path's input quantization); head: the 2D head to the end of
        FarHead."""
        spans.add('backbone', model, model.img_neck, end_pre=True)
        spans.add('head', model.img_roi_head, model.pts_bbox_head)

    def train_sampler(self, model):
        """Decoder layer 0's MSDA sampler."""
        return model.pts_bbox_head.transformer['decoder'].layers[0] \
            .attentions[1].sampler
