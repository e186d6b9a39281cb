"""Rectified-flow model and training configurations (the port's copy of
``pnpflow_tpu/config/rf_configs.py``).

The reference's ml_collections set (``image_generation/configs/``: the
``default_cifar10`` and ``default_lsun`` bases and the 11
``rectified_flow/`` variants) as :class:`CfgNode` trees, built by name with
``get_config(name)``, key for key the JAX package's.  The reference's
``config.device`` is dropped (the port's entry points take ``--opts device``).

They feed ``models/zoo.py:create_model`` and ``rf_main.py``; the ``reflow``
blocks select ``rf_main``'s reflow mode, t-schedule and loss.
"""

from __future__ import annotations

from pnpflow_tpu_torch.utils.config import CfgNode


def _node(**kw):
    return CfgNode(dict(**kw))


def default_cifar10_configs():
    """configs/default_cifar10_configs.py:get_default_configs."""
    return _node(
        training=_node(
            batch_size=128, n_iters=1300001, snapshot_freq=50000,
            log_freq=50, eval_freq=100,
            snapshot_freq_for_preemption=10000, snapshot_sampling=True,
            likelihood_weighting=False, continuous=True, reduce_mean=False,
        ),
        sampling=_node(
            n_steps_each=1, noise_removal=True, probability_flow=False,
            snr=0.16, sigma_variance=0.0, init_noise_scale=1.0,
            use_ode_sampler="rk45", ode_tol=1e-5, sample_N=1000,
        ),
        eval=_node(
            begin_ckpt=9, end_ckpt=26, batch_size=1024,
            enable_sampling=False, num_samples=50000, enable_loss=False,
            enable_bpd=False, bpd_dataset="test",
        ),
        data=_node(
            dataset="CIFAR10", image_size=32, random_flip=True,
            centered=False, uniform_dequantization=False, num_channels=3,
        ),
        model=_node(
            sigma_min=0.01, sigma_max=50, num_scales=1000, beta_min=0.1,
            beta_max=20.0, dropout=0.1, embedding_type="fourier",
        ),
        optim=_node(
            weight_decay=0.0, optimizer="Adam", lr=2e-4, beta1=0.9,
            eps=1e-8, warmup=5000, grad_clip=1.0,
        ),
        seed=42,
    )


def default_lsun_configs():
    """configs/default_lsun_configs.py:get_default_configs."""
    cfg = default_cifar10_configs()
    cfg.training.batch_size = 64
    cfg.training.n_iters = 2400001
    cfg.training.snapshot_freq_for_preemption = 5000
    cfg.sampling.snr = 0.075
    cfg.sampling.use_ode_sampler = "ode"
    cfg.eval.begin_ckpt = 50
    cfg.eval.end_ckpt = 96
    cfg.eval.batch_size = 512
    cfg.data.dataset = "LSUN"
    cfg.data.image_size = 256
    cfg.data.root_path = "YOUR_ROOT_PATH"
    cfg.model.sigma_max = 378
    cfg.model.num_scales = 2000
    cfg.model.dropout = 0.0
    cfg.optim.weight_decay = 0
    return cfg


def _rf_common(cfg):
    cfg.training.sde = "rectified_flow"
    cfg.training.continuous = False
    cfg.training.reduce_mean = True
    cfg.training.snapshot_freq = 100000
    cfg.sampling.method = "rectified_flow"
    cfg.sampling.init_type = "gaussian"
    cfg.sampling.init_noise_scale = 1.0
    cfg.sampling.use_ode_sampler = "rk45"
    cfg.data.centered = True
    cfg.model.name = "ncsnpp"
    return cfg


def _ncsnpp_256(model):
    """The shared 256² NCSN++ block (celeba_hq/afhq/bedroom/church)."""
    model.update(dict(
        scale_by_sigma=True, ema_rate=0.999, normalization="GroupNorm",
        nonlinearity="swish", nf=128, ch_mult=(1, 1, 2, 2, 2, 2, 2),
        num_res_blocks=2, attn_resolutions=(16,), resamp_with_conv=True,
        conditional=True, fir=True, fir_kernel=[1, 3, 3, 1],
        skip_rescale=True, resblock_type="biggan",
        progressive="output_skip", progressive_input="input_skip",
        progressive_combine="sum", attention_type="ddpm", init_scale=0.0,
        fourier_scale=16, conv_size=3,
    ))


def celeba_hq_pytorch_rf_gaussian():
    cfg = _rf_common(default_lsun_configs())
    cfg.training.data_dir = "DATA_DIR"
    cfg.data.dataset = "CelebA-HQ-Pytorch"
    _ncsnpp_256(cfg.model)
    return cfg


def afhq_cat_pytorch_rf_gaussian():
    cfg = _rf_common(default_lsun_configs())
    cfg.training.data_dir = "DATA_DIR"
    cfg.data.dataset = "AFHQ-CAT-Pytorch"
    _ncsnpp_256(cfg.model)
    return cfg


def bedroom_rf_gaussian():
    cfg = _rf_common(default_lsun_configs())
    cfg.data.category = "bedroom"
    _ncsnpp_256(cfg.model)
    return cfg


def church_rf_gaussian():
    cfg = _rf_common(default_lsun_configs())
    cfg.data.category = "church_outdoor"
    _ncsnpp_256(cfg.model)
    return cfg


def _cifar10_ddpmpp_model(model):
    model.update(dict(
        scale_by_sigma=False, ema_rate=0.999999, dropout=0.15,
        normalization="GroupNorm", nonlinearity="swish", nf=128,
        ch_mult=(1, 2, 2, 2), num_res_blocks=4, attn_resolutions=(16,),
        resamp_with_conv=True, conditional=True, fir=False,
        fir_kernel=[1, 3, 3, 1], skip_rescale=True,
        resblock_type="biggan", progressive="none",
        progressive_input="none", progressive_combine="sum",
        attention_type="ddpm", init_scale=0.0,
        embedding_type="positional", fourier_scale=16, conv_size=3,
    ))


def cifar10_rf_gaussian_ddpmpp():
    cfg = _rf_common(default_cifar10_configs())
    _cifar10_ddpmpp_model(cfg.model)
    return cfg


def _cifar10_reflow(reflow_type, t_schedule, loss, extra=None):
    cfg = cifar10_rf_gaussian_ddpmpp()
    cfg.training.snapshot_freq = 20000
    cfg.model.ema_rate = 0.9999
    cfg.model.dropout = 0.1  # reflow variants keep the cifar10 default
    cfg.reflow = _node(
        reflow_type=reflow_type, reflow_t_schedule=t_schedule,
        reflow_loss=loss, last_flow_ckpt="ckpt_path",
        data_root="data_path",
    )
    if extra:
        cfg.reflow.update(extra)
    return cfg


def cifar10_rf_gaussian_reflow_train():
    return _cifar10_reflow("train_reflow", "uniform", "l2")


def cifar10_rf_gaussian_reflow_train_online():
    return _cifar10_reflow("train_online_reflow", "uniform", "l2")


def cifar10_rf_gaussian_reflow_distill_k1():
    return _cifar10_reflow("train_reflow", "t0", "lpips")


def cifar10_rf_gaussian_reflow_distill_k1_online():
    return _cifar10_reflow("train_online_reflow", "t0", "lpips")


def cifar10_rf_gaussian_reflow_distill_k_g_1():
    return _cifar10_reflow("train_reflow", 2, "l2")


def cifar10_rf_gaussian_reflow_generate_data():
    return _cifar10_reflow(
        "generate_data_from_z0", "t0", "l2",
        extra={"total_number_of_samples": 10000},
    )


_CONFIGS = {
    "celeba_hq_pytorch_rf_gaussian": celeba_hq_pytorch_rf_gaussian,
    "afhq_cat_pytorch_rf_gaussian": afhq_cat_pytorch_rf_gaussian,
    "bedroom_rf_gaussian": bedroom_rf_gaussian,
    "church_rf_gaussian": church_rf_gaussian,
    "cifar10_rf_gaussian_ddpmpp": cifar10_rf_gaussian_ddpmpp,
    "cifar10_rf_gaussian_reflow_train": cifar10_rf_gaussian_reflow_train,
    "cifar10_rf_gaussian_reflow_train_online":
        cifar10_rf_gaussian_reflow_train_online,
    "cifar10_rf_gaussian_reflow_distill_k=1":
        cifar10_rf_gaussian_reflow_distill_k1,
    "cifar10_rf_gaussian_reflow_distill_k=1_online":
        cifar10_rf_gaussian_reflow_distill_k1_online,
    "cifar10_rf_gaussian_reflow_distill_k_g_1":
        cifar10_rf_gaussian_reflow_distill_k_g_1,
    "cifar10_rf_gaussian_reflow_generate_data":
        cifar10_rf_gaussian_reflow_generate_data,
}


def get_config(name: str) -> CfgNode:
    """Build a shipped RF config by its reference file stem."""
    if name not in _CONFIGS:
        raise KeyError(
            "Unknown RF config '{}'; available: {}".format(
                name, sorted(_CONFIGS)
            )
        )
    return _CONFIGS[name]()


def available() -> list[str]:
    return sorted(_CONFIGS)
