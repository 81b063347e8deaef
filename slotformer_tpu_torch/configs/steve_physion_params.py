"""STEVE slot encoder on Physion (128x128).

Values match base_slots/configs/steve_physion_params.py in the reference:
10 epochs ~ 460k steps, batch 48, dual LR (model 1e-4 / token decoder 3e-4),
6 slots x 192d, frozen pretrained dVAE. The reference trains it with
``--fp16`` (bf16 autocast in this package's trainer).

``dvae_dict['dvae_ckp_path']`` names the dVAE checkpoint grafted under
``dvae.*`` at the start of training: a ``.pth`` of this package's trainer
(the dVAE at its root) or of the reference, read with ``torch.load``. JAX
``.ckpt.pkl`` files are converted first by ``cli.convert_reference_ckpt``.
Its directory, ``dvae_physion_params``, names the token tree the loader reads
(``TrainNpys-dvae_physion_params/``).
"""

from slotformer_tpu_torch.runtime.params import BaseParams

SLOT_SIZE = 192


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'
    model = 'STEVE'

    # ---- data
    dataset = 'physion_training'
    data_root = './data/Physion'
    tasks = ['all']           # all 8 scenarios
    resolution = (128, 128)
    n_sample_frames = 6
    input_frames = 6
    frame_offset = 1
    video_len = 150
    num_workers = 8
    train_batch_size = 48     # GLOBAL
    val_batch_size = 96

    # ---- model: deterministic slot encoder + GPT token decoder
    slot_dict = dict(
        # object granularity on Physion is ambiguous (is a stack of boxes 1
        # or 6 objects?); 6 slots decompose scenes reasonably
        num_slots=6,
        slot_size=SLOT_SIZE,
        slot_mlp_size=SLOT_SIZE * 2,
        num_iterations=2,
    )
    enc_dict = dict(
        enc_channels=(3, 64, 64, 64, 64),
        enc_ks=5,
        enc_out_channels=SLOT_SIZE,
        enc_norm='',
    )
    dvae_dict = dict(
        down_factor=4,
        vocab_size=4096,
        dvae_ckp_path='pretrained/dvae_physion_params/model.pth',
    )
    dec_dict = dict(dec_num_layers=4, dec_num_heads=4, dec_d_model=SLOT_SIZE)
    pred_dict = dict(
        pred_type='transformer',
        pred_rnn=True,
        pred_norm_first=True,
        pred_num_layers=2,
        pred_num_heads=4,
        pred_ffn_dim=SLOT_SIZE * 4,
        pred_sg_every=None,
    )

    # ---- losses
    loss_dict = dict(use_img_recon_loss=False)
    token_recon_loss_w = 1.
    img_recon_loss_w = 1.

    # ---- optimization: dual-LR Adam (see runtime/schedules.build_optimizer)
    optimizer = 'Adam'
    lr = 1e-4
    dec_lr = 3e-4
    dec_lr_prefixes = ('trans_decoder',)
    clip_grad = 0.05
    warmup_steps_pct = 0.05
    max_epochs = 10
    save_interval = 0.05      # training is slow; save often
    eval_interval = 1
    n_samples = 8
