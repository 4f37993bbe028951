"""``python -m image_captioning_through_rl_tpu_torch`` runs the CLI pipeline
(:func:`.cli.main.run`)."""

from .cli.main import run

if __name__ == "__main__":
    run()
