"""Gradio demo app (port of ``videop2p_tpu/ui/app.py``): tuning, P2P
editing, sampling and Hub-upload tabs over :class:`~videop2p_tpu_torch.ui.
Trainer`, :class:`~videop2p_tpu_torch.ui.InferencePipeline` and
:class:`~videop2p_tpu_torch.ui.ModelUploader`. Gradio is optional: it is
imported by :func:`build_app` alone, which says so when it is missing.

Run:  python -m videop2p_tpu_torch.ui.app [--share] [--engine URL] [--port 7860]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from videop2p_tpu_torch.ui.inference import InferencePipeline
from videop2p_tpu_torch.ui.trainer import Trainer, find_exp_dirs
from videop2p_tpu_torch.ui.upload import ModelUploader, UploadTarget

DEFAULT_BASE_MODEL = "runwayml/stable-diffusion-v1-5"


def build_app(engine_url=None, device="cuda"):
    try:
        import gradio as gr
    except ImportError as exc:  # pragma: no cover - env-dependent
        raise ImportError(
            "the demo UI needs gradio; the CLI entry points "
            "videop2p_tpu_torch.cli.run_tuning / run_videop2p cover the same "
            "functionality without it"
        ) from exc

    trainer = Trainer()
    inference = InferencePipeline(device=device)
    # the Edit tab's serving path: a healthy cli/serve.py engine at this
    # URL (or VIDEOP2P_SERVE_URL) serves edits warm; else the subprocess CLI
    engine_url = engine_url or os.environ.get("VIDEOP2P_SERVE_URL")

    def do_train(video_dir, train_prompt, val_prompt, model_name, base_model,
                 n_steps, lr, seed):
        exp_dir = trainer.run(
            output_model_name=model_name,
            video_path=video_dir,
            training_prompt=train_prompt,
            validation_prompt=val_prompt,
            base_model=base_model or DEFAULT_BASE_MODEL,
            n_steps=int(n_steps),
            learning_rate=float(lr),
            seed=int(seed),
        )
        return f"Training completed! Experiment dir: {exp_dir}"

    def do_edit(exp_dir, video_dir, train_prompt, edit_prompt, blend_src,
                blend_tgt, eq_word, eq_value, cross_steps, self_steps, fast):
        # Stage-1 mangles its on-disk dir with the dependent suffix; the
        # Stage-2 CLI re-derives it from the same (default) flags
        trainer.run_p2p(
            engine_url=engine_url,
            output_dir=exp_dir,
            video_path=video_dir,
            training_prompt=train_prompt,
            editing_prompt=edit_prompt,
            blend_word_src=blend_src,
            blend_word_tgt=blend_tgt,
            eq_word=eq_word,
            eq_value=float(eq_value),
            cross_replace_steps=float(cross_steps),
            self_replace_steps=float(self_steps),
            fast=bool(fast),
        )
        import glob

        gifs = sorted(
            glob.glob(os.path.join(exp_dir + "*", "results_*", "*.gif")),
            key=os.path.getmtime,
        )
        return gifs[-1] if gifs else None

    def do_infer(exp_dir, prompt, steps, guidance, seed):
        inference.load(exp_dir)
        return inference.run(
            prompt, num_steps=int(steps), guidance_scale=float(guidance),
            seed=int(seed), out_path=os.path.join(exp_dir, "sample.gif"),
        )

    with gr.Blocks(title="Video-P2P (H100)", css="h1 { text-align: center; }") as demo:
        gr.Markdown("# Video-P2P — video editing with cross-attention control")
        with gr.Tab("Train"):
            video_dir = gr.Textbox(label="Training video (mp4 or frame dir)")
            train_prompt = gr.Textbox(label="Training prompt")
            val_prompt = gr.Textbox(label="Validation prompt")
            model_name = gr.Textbox(label="Output model name")
            base_model = gr.Textbox(label="Base model", value=DEFAULT_BASE_MODEL)
            n_steps = gr.Number(label="Training steps", value=300)
            lr = gr.Number(label="Learning rate", value=3.5e-5)
            seed = gr.Number(label="Seed", value=0)
            train_out = gr.Textbox(label="Status")
            gr.Button("Train").click(
                do_train,
                [video_dir, train_prompt, val_prompt, model_name, base_model,
                 n_steps, lr, seed],
                train_out,
            )
        with gr.Tab("Edit (P2P)"):
            exp_dir = gr.Dropdown(
                label="Experiment", choices=find_exp_dirs(), allow_custom_value=True
            )
            video_dir2 = gr.Textbox(label="Video (frame dir)")
            train_prompt2 = gr.Textbox(label="Source prompt")
            edit_prompt = gr.Textbox(label="Edited prompt")
            blend_src = gr.Textbox(label="Blend word (source)")
            blend_tgt = gr.Textbox(label="Blend word (edit)")
            eq_word = gr.Textbox(label="Equalizer word")
            eq_value = gr.Number(label="Equalizer value", value=2.0)
            cross_steps = gr.Slider(0, 1, value=0.2, label="Cross-replace steps")
            self_steps = gr.Slider(0, 1, value=0.5, label="Self-replace steps")
            fast = gr.Checkbox(label="Fast mode (skip null-text)", value=True)
            edit_out = gr.Image(label="Edited video")
            gr.Button("Edit").click(
                do_edit,
                [exp_dir, video_dir2, train_prompt2, edit_prompt, blend_src,
                 blend_tgt, eq_word, eq_value, cross_steps, self_steps, fast],
                edit_out,
            )
        with gr.Tab("Sample"):
            exp_dir3 = gr.Dropdown(
                label="Experiment", choices=find_exp_dirs(), allow_custom_value=True
            )
            prompt3 = gr.Textbox(label="Prompt")
            steps3 = gr.Number(label="DDIM steps", value=50)
            guidance3 = gr.Number(label="Guidance scale", value=7.5)
            seed3 = gr.Number(label="Seed", value=0)
            sample_out = gr.Image(label="Sampled video")
            gr.Button("Sample").click(
                do_infer, [exp_dir3, prompt3, steps3, guidance3, seed3], sample_out
            )
        with gr.Tab("Upload"):
            uploader = ModelUploader(os.getenv("HF_TOKEN"))
            exp_dir4 = gr.Dropdown(
                label="Experiment", choices=find_exp_dirs(), allow_custom_value=True
            )
            model_name4 = gr.Textbox(label="Model name (defaults to dir name)")
            upload_to4 = gr.Radio(
                label="Upload to",
                choices=[t.value for t in UploadTarget],
                value=UploadTarget.MODEL_LIBRARY.value,
            )
            private4 = gr.Checkbox(label="Private", value=True)
            delete4 = gr.Checkbox(label="Delete existing repo of the same name",
                                  value=False)
            token4 = gr.Text(label="Hugging Face write token",
                             visible=not os.getenv("HF_TOKEN"))
            upload_msg = gr.Markdown(label="Status")
            gr.Button("Upload").click(
                uploader.upload_model,
                [exp_dir4, model_name4, upload_to4, private4, delete4, token4],
                upload_msg,
            )
    return demo


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--engine", type=str, default=None,
                    help="URL of a running cli/serve.py engine; the Edit "
                         "tab serves through it (warm programs + inversion "
                         "store) instead of spawning a subprocess")
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--device", type=str, default="cuda",
                    help="the Sample tab's device ('cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    build_app(engine_url=args.engine, device=args.device).launch(
        share=args.share, server_port=args.port)
