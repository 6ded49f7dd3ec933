"""Terrain and soil analysis (counterpart of ``rtvm_tpu/slam/terrain.py``):
eight soil types from colour statistics, a moisture index, vegetation cover
with an NDVI-style estimate, texture and roughness classes, erosion risk,
recommendations, a side panel and a text report.

The image statistics are computed on the device in one pass and read in one
transfer; the classification and the report run on the host. The tables
are the JAX module's. The panel's text is drawn with the port's bitmap font
(``utils/draw.py``), where the JAX module uses PIL's DejaVuSans (ROADMAP.md,
Queue 3).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from rtvm_tpu_torch.device import resolve_device
from rtvm_tpu_torch.ops import color, filters
from rtvm_tpu_torch.utils import draw

SOIL_TYPES: Dict[str, dict] = {
    "чернозём": dict(hue=15, sat=80, val=60, fertility="очень высокая", ph="6.5-7.5",
                     crops=["пшеница", "кукуруза", "подсолнечник"]),
    "суглинок": dict(hue=18, sat=90, val=110, fertility="высокая", ph="6.0-7.0",
                     crops=["овощи", "зерновые", "плодовые"]),
    "глина": dict(hue=10, sat=120, val=100, fertility="средняя", ph="7.0-8.0",
                  crops=["рис", "капуста", "свёкла"]),
    "песок": dict(hue=25, sat=60, val=180, fertility="низкая", ph="5.5-6.5",
                  crops=["картофель", "морковь", "арахис"]),
    "супесь": dict(hue=22, sat=70, val=150, fertility="средняя", ph="5.5-7.0",
                   crops=["рожь", "овёс", "люпин"]),
    "торф": dict(hue=12, sat=100, val=45, fertility="высокая", ph="4.0-5.5",
                 crops=["ягодные", "овощи", "зелень"]),
    "каменистая почва": dict(hue=20, sat=30, val=130, fertility="очень низкая", ph="6.0-8.0",
                             crops=["виноград", "лаванда", "травы"]),
    "солончак": dict(hue=24, sat=25, val=200, fertility="очень низкая", ph="8.0-9.5",
                     crops=["солеустойчивые травы"]),
}

STAT_NAMES = ("hue_mean", "sat_mean", "val_mean", "val_std", "green_frac", "dry_veg_frac",
              "ndvi_mean", "darkness", "grad_mean", "lap_var", "low_sat_frac", "bright_frac",
              "gradient_anisotropy")


def _image_stats(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] BGR image -> the STAT_NAMES statistics as one float32
    tensor [13] (on the image's device)."""
    imgf = img.to(torch.float32)
    hsv = color.bgr2hsv(imgf)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    b, g, r = imgf[..., 0], imgf[..., 1], imgf[..., 2]
    gray = color.bgr2gray(imgf)

    green_mask = (h >= 35) & (h <= 85) & (s > 40) & (v > 40)
    dry_veg_mask = (h >= 15) & (h <= 35) & (s > 40) & (v > 90) & (g > b)
    ndvi = (g - r) / torch.clamp(g + r, min=1.0)  # an NDVI-style (G - R) / (G + R)

    gx, gy = filters.sobel(gray)
    grad_mag = torch.sqrt(gx * gx + gy * gy)
    lap = (torch.roll(gray, 1, 0) + torch.roll(gray, -1, 0) + torch.roll(gray, 1, 1)
           + torch.roll(gray, -1, 1) - 4 * gray)

    soil_mask = ~green_mask  # bare-ground pixels for the soil colour
    w = soil_mask.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)
    aniso = (gx.abs().mean() - gy.abs().mean()).abs() / torch.clamp(grad_mag.mean(), min=1e-3)
    v_mean = (v * w).sum() / wsum
    gm = green_mask.to(torch.float32)
    return torch.stack([
        (h * w).sum() / wsum,
        (s * w).sum() / wsum,
        v_mean,
        torch.sqrt(torch.clamp(((v - v_mean) ** 2 * w).sum() / wsum, min=0.0)),
        gm.mean(),
        dry_veg_mask.to(torch.float32).mean(),
        (ndvi * gm).sum() / torch.clamp(gm.sum(), min=1.0),
        1.0 - (v * w).sum() / wsum / 255.0,
        grad_mag.mean(),
        torch.var(lap, unbiased=False),
        ((s < 30) & soil_mask).sum() / wsum,
        ((v > 200) & soil_mask).sum() / wsum,
        aniso,
    ])


class TerrainSoilAnalyzer:
    """Soil and terrain analysis of a BGR image on `device` (``cuda`` unless
    given)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def analyze_image(self, image_bgr) -> dict:
        img = image_bgr if torch.is_tensor(image_bgr) else torch.from_numpy(np.asarray(image_bgr))
        vals = _image_stats(img.to(self.device)).cpu().tolist()
        stats = dict(zip(STAT_NAMES, vals))

        scores = {}
        for name, proto in SOIL_TYPES.items():
            dh = abs(stats["hue_mean"] - proto["hue"]) / 30.0
            ds = abs(stats["sat_mean"] - proto["sat"]) / 120.0
            dv = abs(stats["val_mean"] - proto["val"]) / 150.0
            scores[name] = max(0.0, 1.0 - (0.4 * dh + 0.3 * ds + 0.3 * dv))
        if stats["bright_frac"] > 0.3 and stats["low_sat_frac"] > 0.4:
            scores["солончак"] += 0.3
        if stats["darkness"] > 0.7:
            scores["торф"] += 0.2
            scores["чернозём"] += 0.2
        soil_type = max(scores, key=scores.get)
        confidence = float(np.clip(scores[soil_type], 0.0, 1.0))

        # moisture: darker and more saturated is wetter
        moisture = float(np.clip(0.6 * stats["darkness"] + 0.4 * (stats["sat_mean"] / 255.0), 0, 1))
        moisture_class = "высокая" if moisture > 0.6 else "средняя" if moisture > 0.35 else "низкая"
        veg = stats["green_frac"]
        veg_class = "густая" if veg > 0.5 else "умеренная" if veg > 0.2 else "редкая"
        rough = stats["grad_mean"]
        texture_class = ("крупнозернистая" if rough > 40 else "среднезернистая" if rough > 15
                         else "мелкозернистая")
        # erosion: channels, variance and bare bright soil
        erosion_score = (
            0.5 * min(stats["gradient_anisotropy"] * 2.0, 1.0)
            + 0.3 * min(stats["val_std"] / 80.0, 1.0)
            + 0.2 * min(stats["low_sat_frac"] * 2.0, 1.0)
        ) * (1.0 - 0.5 * veg)
        erosion_class = ("высокий" if erosion_score > 0.55 else "средний" if erosion_score > 0.3
                         else "низкий")

        result = {
            "soil_type": soil_type,
            "confidence": confidence,
            "properties": SOIL_TYPES[soil_type],
            "moisture": moisture,
            "moisture_class": moisture_class,
            "vegetation_cover": veg,
            "vegetation_class": veg_class,
            "dry_vegetation": stats["dry_veg_frac"],
            "ndvi_estimate": stats["ndvi_mean"],
            "texture_class": texture_class,
            "roughness": rough,
            "erosion_risk": erosion_score,
            "erosion_class": erosion_class,
            "stats": stats,
        }
        result["recommendations"] = self._recommendations(result)
        return result

    @staticmethod
    def _recommendations(r: dict) -> list:
        rec = []
        if r["moisture"] < 0.35:
            rec.append("Требуется орошение: влажность почвы низкая")
        if r["moisture"] > 0.7:
            rec.append("Проверить дренаж: возможное переувлажнение")
        if r["erosion_class"] == "высокий":
            rec.append("Противоэрозионные меры: террасирование, посев многолетних трав")
        if r["vegetation_cover"] < 0.2:
            rec.append("Низкий растительный покров: рассмотреть сидераты")
        props = r["properties"]
        rec.append(f"Рекомендуемые культуры: {', '.join(props['crops'])}")
        if props["fertility"] in ("низкая", "очень низкая"):
            rec.append("Внести органические удобрения для повышения плодородия")
        return rec

    @staticmethod
    def panel_lines(result: dict) -> list:
        """(text, colour, size, top y) of each line of the side panel."""
        lines = [
            f"Тип почвы: {result['soil_type']} ({result['confidence']:.2f})",
            f"Плодородие: {result['properties']['fertility']}",
            f"pH: {result['properties']['ph']}",
            f"Влажность: {result['moisture_class']} ({result['moisture']:.2f})",
            f"Растительность: {result['vegetation_class']} ({result['vegetation_cover']*100:.0f}%)",
            f"NDVI (оценка): {result['ndvi_estimate']:.2f}",
            f"Текстура: {result['texture_class']}",
            f"Риск эрозии: {result['erosion_class']} ({result['erosion_risk']:.2f})",
        ]
        out, y = [], 30
        for ln in lines:
            out.append((ln, (220, 220, 220), 15, y))
            y += 26
        y += 10
        for rec in result["recommendations"]:
            out.append(("- " + rec, (120, 220, 120), 13, y))
            y += 40
        return out

    def visualize(self, image_bgr: np.ndarray, result: dict) -> np.ndarray:
        """The image with a 360-px panel of the result on its right."""
        h, w = image_bgr.shape[:2]
        out = np.zeros((h, w + 360, 3), np.uint8)
        out[:, :w] = image_bgr
        out[:, w:] = (35, 35, 35)
        for text, colr, size, y in self.panel_lines(result):
            draw.put_text_top(out, text, (w + 12, y), colr, size=size)
        return out

    def report(self, result: dict) -> str:
        p = result["properties"]
        lines = [
            "=" * 50,
            "ОТЧЁТ ОБ АНАЛИЗЕ ПОЧВЫ И РЕЛЬЕФА",
            "=" * 50,
            f"Тип почвы: {result['soil_type']} (уверенность {result['confidence']:.2f})",
            f"  Плодородие: {p['fertility']}",
            f"  pH: {p['ph']}",
            f"Влажность: {result['moisture_class']} ({result['moisture']:.2f})",
            f"Растительный покров: {result['vegetation_class']} "
            f"({result['vegetation_cover']*100:.1f}%), NDVI~{result['ndvi_estimate']:.2f}",
            f"Текстура поверхности: {result['texture_class']} "
            f"(шероховатость {result['roughness']:.1f})",
            f"Риск эрозии: {result['erosion_class']} ({result['erosion_risk']:.2f})",
            "",
            "Рекомендации:",
        ]
        lines += [f"  * {r}" for r in result["recommendations"]]
        lines.append("=" * 50)
        return "\n".join(lines)
