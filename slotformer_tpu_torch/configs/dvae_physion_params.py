"""dVAE tokenizer on Physion (reference base_slots/configs/dvae_physion_params.py).

The trainer writes ``model_<it>.pth`` files holding the dVAE at their root;
the STEVE config grafts one from ``pretrained/dvae_physion_params/model.pth``,
and ``cli/tokenize_images.py`` reads one through ``--weight``.
"""

from slotformer_tpu_torch.runtime.params import BaseParams


class SlotFormerParams(BaseParams):
    project = 'SlotFormer-TPU'

    max_epochs = 20  # ~700k steps
    save_interval = 0.25
    eval_interval = 1
    n_samples = 8  # 8 Physion scenarios

    optimizer = 'Adam'
    lr = 1e-3
    warmup_steps_pct = 0.05

    dataset = 'physion_training'
    data_root = './data/Physion'
    tasks = ['all']
    n_sample_frames = 1  # single frames
    frame_offset = 1
    video_len = 150
    train_batch_size = 64  # GLOBAL
    val_batch_size = 128
    num_workers = 8

    model = 'dVAE'
    resolution = (128, 128)
    vocab_size = 4096

    # gumbel-softmax temperature: 1.0 -> 0.1 over the first 15% of steps
    init_tau = 1.
    final_tau = 0.1
    tau_decay_pct = 0.15

    recon_loss_w = 1.
