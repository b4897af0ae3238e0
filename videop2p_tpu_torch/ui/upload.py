"""HF Hub distribution (port of ``videop2p_tpu/ui/upload.py``): create a repo
and upload a trained experiment directory — resolve the organization,
optionally delete an existing repo, create it, upload the folder, return
the landing URL. ``huggingface_hub`` is imported by the default API factory
only; tests inject a fake API and reach no network.
"""

from __future__ import annotations

import enum
import pathlib
from typing import Callable, Optional

from videop2p_tpu_torch.ui.trainer import _slugify

__all__ = [
    "UploadTarget",
    "MODEL_LIBRARY_ORG_NAME",
    "SAMPLE_MODEL_REPO",
    "Uploader",
    "ModelUploader",
]


class UploadTarget(enum.Enum):
    PERSONAL_PROFILE = "Personal Profile"
    MODEL_LIBRARY = "Video-P2P Library"


MODEL_LIBRARY_ORG_NAME = "Video-P2P-library"
# the hosted demo's sample checkpoint
SAMPLE_MODEL_REPO = "Video-P2P-library/a-man-is-surfing"


def _default_api_factory(token: Optional[str]):
    from huggingface_hub import HfApi

    return HfApi(token=token)


class Uploader:
    """The upload flow; ``api_factory`` lets tests run without
    huggingface_hub or a network."""

    def __init__(self, hf_token: Optional[str],
                 api_factory: Callable = _default_api_factory):
        self.hf_token = hf_token
        self._api_factory = api_factory

    def upload(
        self,
        folder_path: str,
        repo_name: str,
        *,
        organization: str = "",
        repo_type: str = "model",
        private: bool = True,
        delete_existing_repo: bool = False,
        input_token: Optional[str] = None,
    ) -> str:
        if not folder_path:
            raise ValueError("folder_path is required")
        if not repo_name:
            raise ValueError("repo_name is required")
        api = self._api_factory(self.hf_token if self.hf_token else input_token)
        if not organization:
            organization = api.whoami()["name"]
        repo_id = f"{organization}/{repo_name}"
        if delete_existing_repo:
            try:
                api.delete_repo(repo_id, repo_type=repo_type)
            except Exception:
                pass
        try:
            api.create_repo(repo_id, repo_type=repo_type, private=private)
            api.upload_folder(
                repo_id=repo_id, folder_path=folder_path, path_in_repo=".",
                repo_type=repo_type,
            )
            url = f"https://huggingface.co/{repo_id}"
            return (
                f'Your model was successfully uploaded to '
                f'<a href="{url}" target="_blank">{url}</a>.'
            )
        except Exception as e:  # surface the API error as the status message
            return str(e)


class ModelUploader(Uploader):
    """Name defaulting, slugify and target-organization routing."""

    def upload_model(
        self,
        folder_path: str,
        repo_name: str,
        upload_to: str,
        private: bool = True,
        delete_existing_repo: bool = False,
        input_token: Optional[str] = None,
    ) -> str:
        if not folder_path:
            raise ValueError("folder_path is required")
        if not repo_name:
            repo_name = pathlib.Path(folder_path).name
        repo_name = _slugify(repo_name)
        if upload_to == UploadTarget.PERSONAL_PROFILE.value:
            organization = ""
        elif upload_to == UploadTarget.MODEL_LIBRARY.value:
            organization = MODEL_LIBRARY_ORG_NAME
        else:
            raise ValueError(f"unknown upload target: {upload_to!r}")
        return self.upload(
            folder_path, repo_name,
            organization=organization, private=private,
            delete_existing_repo=delete_existing_repo, input_token=input_token,
        )
